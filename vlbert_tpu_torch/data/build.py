"""Dataloader factory (port side of vlbert_tpu/data/build.py, which imports
jax): cfg -> (transform, dataset, collate, loader).

The dataset, collate, loader, tokenizer and transforms are the JAX
package's host code (numpy, no jax), reused unchanged. Rank and world size
come from ``torch.distributed`` when it is initialised, else 0 and 1; each
process loads its own shard. Ported so far: VQA; the other datasets are
ROADMAP.md queue 1.
"""

from __future__ import annotations

import os

from vlbert_tpu.data.datasets.vqa import VQADataset, make_vqa_collate
from vlbert_tpu.data.loader import DataLoader
from vlbert_tpu.data.tokenization import BertTokenizer
from vlbert_tpu_torch.data.transforms import build_transforms


def dist_rank_world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _mode_fields(cfg, mode):
    d = cfg.DATASET
    if mode == "train":
        return (d.TRAIN_ANNOTATION_FILE, d.TRAIN_IMAGE_SET,
                cfg.TRAIN.BATCH_IMAGES, cfg.TRAIN.SHUFFLE)
    if mode == "val":
        return (d.VAL_ANNOTATION_FILE, d.VAL_IMAGE_SET, cfg.VAL.BATCH_IMAGES,
                cfg.VAL.SHUFFLE)
    return (d.TEST_ANNOTATION_FILE, d.TEST_IMAGE_SET, cfg.TEST.BATCH_IMAGES,
            cfg.TEST.SHUFFLE)


def make_dataloader(cfg, task, mode="train", tokenizer=None, num_replicas=None,
                    rank=None):
    """One loader of per-process batches: BATCH_IMAGES (one card per
    process) times GRAD_ACCUMULATE_STEPS for training, flat."""
    d = cfg.DATASET
    if d.DATASET != "vqa":
        raise NotImplementedError(f"dataset {d.DATASET!r} is not ported yet; "
                                  f"see ROADMAP.md queue 1")
    if d.get("CACHE_MODE", False):
        raise NotImplementedError(
            "DATASET.CACHE_MODE (whole-dataset RAM cache) is not supported, "
            "matching the reference's own assert")
    ann_file, image_set, batch_images, shuffle = _mode_fields(cfg, mode)
    if mode == "train":
        batch_images *= max(int(cfg.TRAIN.GRAD_ACCUMULATE_STEPS), 1)
    r, w = dist_rank_world()
    rank = r if rank is None else rank
    num_replicas = w if num_replicas is None else num_replicas

    tokenizer = tokenizer or BertTokenizer.from_pretrained(
        cfg.NETWORK.BERT_MODEL_NAME)
    precomputed = cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED
    device_norm = cfg.TPU.get("DEVICE_IMAGE_NORM", True) and not precomputed
    transform = build_transforms(cfg, mode, device_norm=device_norm)
    test_mode = mode == "test"
    ds = VQADataset(
        ann_file=ann_file, image_set=image_set, root_path=d.ROOT_PATH,
        data_path=d.DATASET_PATH, tokenizer=tokenizer, transform=transform,
        test_mode=test_mode, zip_mode=d.ZIP_MODE,
        add_image_as_a_box=d.ADD_IMAGE_AS_A_BOX,
        answer_vocab_file=d.ANSWER_VOCAB_FILE,
        with_precomputed_visual_feat=precomputed,
        boxes=d.get("BOXES", "36"), use_imdb=d.get("USE_IMDB", True))
    collate = make_vqa_collate(
        tokenizer, cfg.TPU.MAX_TEXT_LEN, cfg.TPU.MAX_BOXES,
        precomputed_dim=d.get("PRECOMPUTED_FEAT_DIM", 2048)
        if precomputed else 0, test_mode=test_mode)
    n_workers = min(cfg.NUM_WORKERS_PER_GPU, max((os.cpu_count() or 1) - 1, 0))
    use_procs = cfg.TPU.get("PROCESS_WORKERS", True) and n_workers > 0
    return DataLoader(ds, batch_images, collate,
                      shuffle=shuffle and mode == "train",
                      num_replicas=num_replicas, rank=rank,
                      seed=max(cfg.RNG_SEED, 0), drop_last=(mode == "train"),
                      prefetch=cfg.TPU.get("PREFETCH_DEPTH", 2), num_threads=1,
                      num_workers=n_workers if use_procs else 0,
                      aspect_grouping=(mode == "train"
                                       and cfg.TRAIN.ASPECT_GROUPING))
