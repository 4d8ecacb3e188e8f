"""Dataloader factory (port side of vlbert_tpu/data/build.py, which imports
jax): cfg -> (transform, dataset, collate, loader).

The dataset, collate, loader, tokenizer and transforms are the port's
copies of the JAX package's host code (numpy, no jax). Rank and world size
come from ``torch.distributed`` when it is initialised, else 0 and 1; each
process loads its own shard. Every dataset of the JAX package's catalog
is ported: VQA, RefCOCO / RefCOCO+, VCR, and for pretraining Conceptual
Captions, COCO captions and the text corpus, whose list-valued DATASET
gives ``make_multitask_dataloader``.
"""

from __future__ import annotations

import os

from vlbert_tpu_torch.data.datasets.coco_captions import COCOCaptionsDataset
from vlbert_tpu_torch.data.datasets.conceptual_captions import (
    ConceptualCaptionsDataset, GeneralCorpusDataset, make_corpus_collate,
    make_pretrain_collate)
from vlbert_tpu_torch.data.datasets.refcoco import (RefCOCODataset,
                                                    make_refcoco_collate)
from vlbert_tpu_torch.data.datasets.vcr import VCRDataset, make_vcr_collate
from vlbert_tpu_torch.data.datasets.vqa import VQADataset, make_vqa_collate
from vlbert_tpu_torch.data.loader import DataLoader, MultiTaskLoader
from vlbert_tpu_torch.data.tokenization import BertTokenizer
from vlbert_tpu_torch.data.transforms import build_transforms
from vlbert_tpu_torch.utils.misc import master_dataset


def dist_rank_world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


CAPTION_DATASETS = {"conceptual_captions": ConceptualCaptionsDataset,
                    "coco_captions": COCOCaptionsDataset}


def _mode_fields(cfg, mode):
    d = master_dataset(cfg)
    if mode == "train":
        return (d.TRAIN_ANNOTATION_FILE, d.TRAIN_IMAGE_SET,
                cfg.TRAIN.BATCH_IMAGES, cfg.TRAIN.SHUFFLE)
    if mode == "val":
        return (d.VAL_ANNOTATION_FILE, d.VAL_IMAGE_SET, cfg.VAL.BATCH_IMAGES,
                cfg.VAL.SHUFFLE)
    return (d.TEST_ANNOTATION_FILE, d.TEST_IMAGE_SET, cfg.TEST.BATCH_IMAGES,
            cfg.TEST.SHUFFLE)


def make_dataloader(cfg, task, mode="train", tokenizer=None, num_replicas=None,
                    rank=None, worker_share=1, dataset_index=0):
    """One loader of per-process batches: BATCH_IMAGES (one card per
    process; a list gives each of the multitask sub-loaders its entry)
    times GRAD_ACCUMULATE_STEPS for training, flat. ``worker_share``
    divides the host's cores among concurrent sub-loaders;
    ``dataset_index`` decorrelates their RNG streams."""
    d = master_dataset(cfg)
    if d.DATASET not in ("vqa", "refcoco", "refcoco+", "vcr",
                         "general_corpus", *CAPTION_DATASETS):
        raise ValueError(f"unknown dataset {d.DATASET!r}")
    if d.get("CACHE_MODE", False):
        raise NotImplementedError(
            "DATASET.CACHE_MODE (whole-dataset RAM cache) is not supported, "
            "matching the reference's own assert")
    if d.get("QA2R_AUG", False):
        # reference: `assert not qa2r_aug, "Not implemented!"` (vcr.py:62)
        raise NotImplementedError("DATASET.QA2R_AUG is not implemented, "
                                  "matching the reference's own assert")
    ann_file, image_set, batch_images, shuffle = _mode_fields(cfg, mode)
    if isinstance(batch_images, (list, tuple)):
        batch_images = batch_images[min(dataset_index,
                                        len(batch_images) - 1)]
    if mode == "train":
        batch_images *= max(int(cfg.TRAIN.GRAD_ACCUMULATE_STEPS), 1)
    r, w = dist_rank_world()
    rank = r if rank is None else rank
    num_replicas = w if num_replicas is None else num_replicas

    tokenizer = tokenizer or BertTokenizer.from_pretrained(
        cfg.NETWORK.BERT_MODEL_NAME)
    precomputed = cfg.NETWORK.IMAGE_FEAT_PRECOMPUTED
    device_norm = cfg.TPU.get("DEVICE_IMAGE_NORM", True) and not precomputed
    if d.DATASET in CAPTION_DATASETS and cfg.NETWORK.MASK_RAW_PIXELS:
        # masked RoIs are zeroed in normalized space, which uint8 pixels
        # cannot hold: such a loader normalizes on the host
        device_norm = False
    transform = build_transforms(cfg, mode, device_norm=device_norm)
    test_mode = mode == "test"
    common = dict(
        ann_file=ann_file, image_set=image_set, root_path=d.ROOT_PATH,
        data_path=d.DATASET_PATH, tokenizer=tokenizer, transform=transform,
        test_mode=test_mode, zip_mode=d.ZIP_MODE,
        add_image_as_a_box=d.ADD_IMAGE_AS_A_BOX)
    max_text, max_boxes = cfg.TPU.MAX_TEXT_LEN, cfg.TPU.MAX_BOXES
    if d.DATASET in CAPTION_DATASETS:
        # the zero-image fallback's fill: the rounded pixel means in RGB,
        # which normalize to ~0.0
        means_bgr = cfg.NETWORK.PIXEL_MEANS or (102.9801, 115.9465, 122.7717)
        net = cfg.NETWORK
        ds = CAPTION_DATASETS[d.DATASET](
            fallback_fill_rgb=tuple(int(round(float(m)))
                                    for m in means_bgr[::-1]),
            with_precomputed_visual_feat=precomputed,
            mask_raw_pixels=net.MASK_RAW_PIXELS,
            with_rel_task=net.WITH_REL_LOSS, with_mlm_task=net.WITH_MLM_LOSS,
            with_mvrc_task=net.WITH_MVRC_LOSS, seq_len=d.get("SEQ_LEN", 64),
            **common)
        collate = make_pretrain_collate(
            max_text, max_boxes, net.VLBERT.visual_region_classes,
            precomputed_dim=d.get("PRECOMPUTED_FEAT_DIM", 2048)
            if precomputed else 0)
    elif d.DATASET == "general_corpus":
        ds = GeneralCorpusDataset(ann_file=ann_file, tokenizer=tokenizer,
                                  seq_len=d.get("SEQ_LEN", 64),
                                  min_seq_len=d.get("MIN_SEQ_LEN", 64))
        collate = make_corpus_collate(max_text)
    elif d.DATASET == "vcr":
        mask_size = (d.MASK_SIZE, d.MASK_SIZE)
        ds = VCRDataset(task=d.TASK,
                        only_use_relevant_dets=d.ONLY_USE_RELEVANT_DETS,
                        mask_size=mask_size, basic_align=d.BASIC_ALIGN,
                        qa2r_noq=d.QA2R_NOQ, seq_len=d.get("SEQ_LEN", 64),
                        cache_db=(rank == 0),  # only rank 0 writes the cache
                        ignore_db_cache=d.get("IGNORE_DB_CACHE", True),
                        **common)
        collate = make_vcr_collate(
            tokenizer, max_text, max_boxes, mask_size=mask_size,
            answer_first=cfg.NETWORK.get("ANSWER_FIRST", False),
            one_sent=cfg.NETWORK.get("QA_ONE_SENT", False),
            test_mode=test_mode, task=d.TASK)
    elif d.DATASET == "vqa":
        ds = VQADataset(
            answer_vocab_file=d.ANSWER_VOCAB_FILE,
            with_precomputed_visual_feat=precomputed,
            boxes=d.get("BOXES", "36"), use_imdb=d.get("USE_IMDB", True),
            **common)
        collate = make_vqa_collate(
            tokenizer, max_text, max_boxes,
            precomputed_dim=d.get("PRECOMPUTED_FEAT_DIM", 2048)
            if precomputed else 0, test_mode=test_mode)
    else:
        boxes_field = {"train": "TRAIN_BOXES", "val": "VAL_BOXES",
                       "test": "TEST_BOXES"}[mode]
        ds = RefCOCODataset(boxes=d.get(boxes_field, "gt"),
                            proposal_source=d.get("PROPOSAL_SOURCE",
                                                  "official"), **common)
        collate = make_refcoco_collate(tokenizer, max_text, max_boxes,
                                       test_mode=test_mode)
    n_workers = min(cfg.NUM_WORKERS_PER_GPU,
                    max(((os.cpu_count() or 1) - 1) // max(worker_share, 1),
                        0))
    use_procs = cfg.TPU.get("PROCESS_WORKERS", True) and n_workers > 0
    return DataLoader(ds, batch_images, collate,
                      shuffle=shuffle and mode == "train",
                      num_replicas=num_replicas, rank=rank,
                      seed=max(cfg.RNG_SEED, 0), drop_last=(mode == "train"),
                      prefetch=cfg.TPU.get("PREFETCH_DEPTH", 2), num_threads=1,
                      num_workers=n_workers if use_procs else 0,
                      aspect_grouping=(mode == "train"
                                       and cfg.TRAIN.ASPECT_GROUPING),
                      loader_id=dataset_index)


def make_multitask_dataloader(cfg, task, mode="train", tokenizer=None):
    """A list-valued DATASET: the master loader zipped with the others,
    each built from a clone of ``cfg`` holding its own entry; their
    batches concatenate tuple-wise."""
    loaders = []
    for i, ds_cfg in enumerate(cfg.DATASET):
        sub = cfg.clone()
        sub.DATASET = ds_cfg
        loaders.append(make_dataloader(sub, task, mode, tokenizer,
                                       worker_share=len(cfg.DATASET),
                                       dataset_index=i))
    return MultiTaskLoader(loaders)
