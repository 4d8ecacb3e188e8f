"""Config system: attribute-dict default trees + strict-keyed YAML overlay.

Single implementation parameterized by task, replacing the reference's four
near-identical copies (ref: vcr/function/config.py:174-202,
pretrain/function/config.py:182-216 for the list-DATASET variant). Semantics
preserved:

* every YAML key must already exist in the default tree (strict check),
* ``TRAIN.LR_STEP`` is parsed from a csv string to a tuple of floats,
* ``TRAIN.LOSS_LOGGERS`` is parsed from a list of csv strings to tuples,
* top-level ``SCALES`` becomes a tuple,
* ``NETWORK.VLBERT`` is merged key-by-key with strict check,
* pretrain-style ``DATASET`` may be a *list* of dataset dicts, each filled
  from the DATASET default template.

On top of the reference surface we add a ``TPU`` section (mesh axes, dtype
policy, static-shape bucket sizes) with defaults that reproduce reference
behavior when untouched.

Port copy of ``vlbert_tpu/utils/config.py``, unchanged but for its imports:
the port imports nothing of the JAX package.
``tests/test_torch_host_copies.py`` holds it to the original.
"""

from __future__ import annotations

import copy
import os

import yaml


class AttrDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        d = dict(d, **kwargs)
        for k, v in d.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, AttrDict):
            value = AttrDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                AttrDict(v) if isinstance(v, dict) and not isinstance(v, AttrDict) else v
                for v in value
            )
        super().__setitem__(key, value)

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def clone(self):
        return copy.deepcopy(self)


class FrozenConfig:
    """Read-only attribute view over an AttrDict tree.

    Not a dict subclass, so Flax module attributes keep attribute access
    (Flax rewrites plain dict attributes into FrozenDicts).
    """

    __slots__ = ("_d",)

    def __init__(self, d):
        object.__setattr__(self, "_d", d)

    def __getattr__(self, key):
        try:
            v = self._d[key]
        except KeyError as e:
            raise AttributeError(key) from e
        return FrozenConfig(v) if isinstance(v, dict) else v

    def __getitem__(self, key):
        v = self._d[key]
        return FrozenConfig(v) if isinstance(v, dict) else v

    def __contains__(self, key):
        return key in self._d

    def __setattr__(self, key, value):
        raise AttributeError("FrozenConfig is read-only")

    def items(self):
        return self._d.items()

    def get(self, key, default=None):
        v = self._d.get(key, default)
        return FrozenConfig(v) if isinstance(v, dict) else v

    def raw(self):
        return self._d

    def __repr__(self):
        return f"FrozenConfig({self._d!r})"

    def __eq__(self, other):
        return isinstance(other, FrozenConfig) and self._d == other._d

    def __hash__(self):
        # stable content hash (AttrDicts are plain dicts underneath)
        import json

        return hash(json.dumps(self._d, sort_keys=True, default=str))


def _common_config():
    """Options shared by all four tasks (ref: vcr/function/config.py:10-19)."""
    c = AttrDict()
    c.RNG_SEED = -1
    c.OUTPUT_PATH = ""
    c.MODULE = ""
    c.GPUS = ""
    c.LOG_FREQUENT = 50
    c.VAL_FREQUENT = 1
    c.CHECKPOINT_FREQUENT = 1
    c.MODEL_PREFIX = ""
    c.NUM_WORKERS_PER_GPU = 4
    c.SCALES = ()

    d = c.DATASET = AttrDict()
    d.DATASET = ""
    d.LABEL_INDEX_IN_BATCH = -1
    d.APPEND_INDEX = False
    d.TASK = "Q2AR"
    d.BASIC_ALIGN = False
    d.DATASET_PATH = ""
    d.ROOT_PATH = ""
    d.TRAIN_IMAGE_SET = ""
    d.VAL_IMAGE_SET = ""
    d.TEST_IMAGE_SET = ""
    d.TRAIN_ANNOTATION_FILE = ""
    d.VAL_ANNOTATION_FILE = ""
    d.TEST_ANNOTATION_FILE = ""
    d.ONLY_USE_RELEVANT_DETS = True
    d.ADD_IMAGE_AS_A_BOX = True
    d.ZIP_MODE = False
    d.CACHE_MODE = False
    d.IGNORE_DB_CACHE = True
    d.MASK_SIZE = 14
    d.QA2R_NOQ = False
    d.QA2R_AUG = False
    # precomputed bottom-up feature width (the reference hardcodes 2048,
    # common/fast_rcnn.py:105-109; configurable here for synthetic data)
    d.PRECOMPUTED_FEAT_DIM = 2048

    n = c.NETWORK = AttrDict()
    n.BLIND = False
    n.NO_GROUNDING = False
    n.PARTIAL_PRETRAIN = ""
    n.PARTIAL_PRETRAIN_PREFIX_CHANGES = []
    n.FOR_MASK_VL_MODELING_PRETRAIN = False
    n.NO_OBJ_ATTENTION = False
    n.IMAGE_NUM_LAYERS = 50
    n.IMAGE_C5_DILATED = False
    n.IMAGE_STRIDE_IN_1x1 = False
    n.PIXEL_MEANS = ()
    n.PIXEL_STDS = ()
    n.IMAGE_FEAT_PRECOMPUTED = False
    n.IMAGE_PRETRAINED = ""
    n.IMAGE_PRETRAINED_EPOCH = 0
    n.IMAGE_FROZEN_BACKBONE_STAGES = [1, 2]
    n.IMAGE_FROZEN_BN = True
    n.IMAGE_FINAL_DIM = 512
    n.IMAGE_SEMANTIC = False
    n.OUTPUT_CONV5 = False
    n.BERT_MODEL_NAME = "bert-base-uncased"
    n.BERT_PRETRAINED = ""
    n.BERT_PRETRAINED_EPOCH = 0
    n.BERT_FROZEN = True
    n.BERT_ALIGN_QUESTION = True
    n.BERT_ALIGN_ANSWER = True
    n.BERT_USE_LAYER = -2
    n.BERT_WITH_NSP_LOSS = False
    n.BERT_WITH_MLM_LOSS = False
    n.ENABLE_CNN_REG_LOSS = False
    n.CNN_LOSS_WEIGHT = 1.0
    n.ANS_LOSS_WEIGHT = 1.0

    v = n.VLBERT = AttrDict()
    v.input_size = 1280
    v.input_transform_type = 1
    v.word_embedding_frozen = False
    v.obj_pos_id_relative = True
    v.hidden_size = 512
    v.visual_size = 512
    v.num_hidden_layers = 4
    v.num_attention_heads = 8
    v.intermediate_size = 2048
    v.hidden_act = "gelu"
    v.hidden_dropout_prob = 0.1
    v.attention_probs_dropout_prob = 0.1
    v.max_position_embeddings = 512
    v.type_vocab_size = 3
    v.vocab_size = 30522
    v.initializer_range = 0.02
    v.visual_scale_text_init = 0.0
    v.visual_scale_object_init = 0.0
    v.visual_ln = False
    v.object_word_embed_mode = 2
    v.with_pooler = False
    v.position_padding_idx = -1

    n.CLASSIFIER_TYPE = "2fc"  # 2fc / 1fc / mlm
    n.CLASSIFIER_HIDDEN_SIZE = 1024
    n.CLASSIFIER_DROPOUT = 0.1
    n.CLASSIFIER_SIGMOID = False
    n.CLASSIFIER_SIGMOID_LOSS_POSITIVE_WEIGHT = 1.0

    t = c.TRAIN = AttrDict()
    t.LR_MULT = []
    t.SHUFFLE = True
    t.FLIP_PROB = 0.5
    t.BATCH_IMAGES = 1
    # default False (reference default tree says True, but its VCR/CC
    # datasets assert/KeyError when grouping is actually requested, and all
    # 16 shipped YAMLs set it explicitly); RefCOCO/VQA honor it via
    # dataset group_ids + GroupedBatchSampler
    t.ASPECT_GROUPING = False
    t.RESUME = False
    t.AUTO_RESUME = True
    t.BEGIN_EPOCH = 0
    t.END_EPOCH = 0
    t.OPTIMIZER = "SGD"
    t.CLIP_GRAD_NORM = -1
    t.GRAD_ACCUMULATE_STEPS = 1
    t.LR = 0.1
    t.LR_SCHEDULE = "step"  # step / triangle / plateau
    t.LR_FACTOR = 0.1
    t.LR_STEP = ()
    t.WARMUP = False
    t.WARMUP_METHOD = "linear"
    t.WARMUP_FACTOR = 1.0 / 3
    t.WARMUP_STEPS = 1000
    t.WD = 0.0001
    t.MOMENTUM = 0.9
    t.FP16 = False
    t.FP16_LOSS_SCALE = 128.0
    t.LOSS_LOGGERS = []

    va = c.VAL = AttrDict()
    va.SHUFFLE = False
    va.FLIP_PROB = 0
    va.BATCH_IMAGES = 1

    te = c.TEST = AttrDict()
    te.SHUFFLE = False
    te.FLIP_PROB = 0
    te.TEST_EPOCH = 0
    te.BATCH_IMAGES = 1

    # --- TPU-native additions (no reference counterpart) ---
    tp = c.TPU = AttrDict()
    tp.MESH_SHAPE = []           # e.g. [8] or [4, 2]; [] = all local devices on 'data'
    tp.MESH_AXES = ["data"]      # axis names; 2nd axis (if any) is 'model'
    # how TrainState lives between steps: 'dp' replicates (reference
    # semantics), 'tp' shards big kernels over a 'model' axis
    # (param_sharding_rules), 'fsdp' shards params+Adam moments over 'data'
    # (ZeRO-style, ~dp x less state HBM; fsdp_sharding_rules). Compute is
    # identical — XLA inserts the gathers/scatters.
    tp.PARTITION_MODE = "dp"
    tp.COMPUTE_DTYPE = "bfloat16"  # bf16 matmuls/convs; fp32 LN/softmax accumulation
    # (params are always fp32 — master weights; no PARAM_DTYPE knob)
    tp.MAX_TEXT_LEN = 64         # static text bucket
    tp.MAX_BOXES = 108           # static box bucket (incl. whole-image box)
    tp.IMAGE_SIZE = []           # [] = derive (max canvas) from SCALES
    tp.PREFETCH_DEPTH = 2
    # ship uint8 images to the device and fuse the BGR255-mean normalize
    # into the jitted step (4x less host traffic + H2D; ops/image_norm.py);
    # auto-disabled where pixels are mutated in normalized space (CC
    # MASK_RAW_PIXELS)
    tp.DEVICE_IMAGE_NORM = True
    # fork-pool dataset workers (one collated batch per task); 0 threads
    # fallback is selected by PROCESS_WORKERS=False or NUM_WORKERS_PER_GPU=0
    tp.PROCESS_WORKERS = True
    # true fp16 compute + the reference's static loss scale for TRAIN.FP16
    # configs (parity experiments); default maps TRAIN.FP16 to bf16
    tp.FP16_PARITY_MODE = False
    tp.REMAT = False             # jax.checkpoint over encoder layers
    # 'rbg' halves dropout cost vs threefry on TPU (dropout RNG measured ~2x
    # encoder fwd time); 'threefry2x32' for cross-platform reproducibility
    tp.RNG_IMPL = "rbg"
    # dropout mask construction (ops/dropout.py): 'bits16' = uint16
    # threshold compare (half the PRNG words of bernoulli, no int->float
    # pass; keep-prob quantized to 1/65536 — measured 33 ms/step of
    # threefry-bernoulli mask cost on the v5e VQA fine-tune step);
    # 'ref' = jax.random.bernoulli, bit-identical to flax nn.Dropout;
    # 'pallas' = TPU hardware-PRNG kernel (bits generated in VMEM, backward
    # regenerates the mask from a 32-bit seed — no mask residuals).
    # env override exists for A/B harnesses (tools/profile_step.py)
    tp.DROPOUT_IMPL = os.environ.get("VLBERT_DROPOUT_IMPL", "bits16")
    # host-side image resize (data/transforms.py _resize_bilinear): 'pil' =
    # exact reference parity (torchvision-on-PIL antialiased bilinear);
    # 'cv2' = OpenCV INTER_LINEAR, ~5x faster per image and <=1 LSB mean
    # divergence at this pipeline's near-unity scales — shipped in the
    # v5e-tuned configs where the 1-core-class host must feed the chip
    tp.RESIZE_IMPL = "pil"
    # single [H, 3H] QKV projection: measured 23% faster encoder backward on
    # v5e (17.7 vs 23.1 ms at [32, 85]); reference checkpoints are fused on
    # load by training/convert.fuse_qkv_params
    tp.FUSED_QKV = True
    # rematerialize the attention core (QK^T+softmax+prob-dropout+PV):
    # save only (q,k,v,bias,key) between fwd and bwd and regenerate the
    # fp32 [B,H,L,L] probs + dropout mask in the backward (~650 MB fewer
    # residuals at VQA B=64). MEASURED SLOWER on v5e (79.2 vs 69.7 ms/step,
    # VQA B=64): XLA's softmax-backward re-materializes probs in HBM anyway
    # — without flash-style tiling the fwd store is just replaced by a bwd
    # store plus recompute. Keep off unless activation memory binds.
    tp.ATTN_REMAT = os.environ.get("VLBERT_ATTN_REMAT", "0") \
        not in ("0", "false")
    # nn.scan over encoder layers: ~num_layers x faster train-step compiles
    # (attention-vis and per-layer outputs need the unrolled path); params
    # stack as encoder.layers.layer.[L, ...] (convert.stack_layer_params)
    tp.SCAN_LAYERS = False
    # persistent XLA compile cache (big train-step graphs compile in minutes)
    tp.COMPILE_CACHE_DIR = "~/.cache/vlbert_tpu_xla"
    # Pallas fused attention kernel. MEASURED SLOWER than XLA's own fusion at
    # VL-BERT's short sequence lengths (372 vs 433 img/s on v5e for the
    # base fwd bench: lane padding to 128 dominates at L~85-150), so off by
    # default; available for long-box configs where padding amortizes.
    tp.FUSED_ATTENTION = False
    # ROIAlign implementation: 'xla' = separable-matmul einsum formulation,
    # 'pallas' = hand-written gather/bilinear kernel. Measured on v5e at the
    # bench shape (608px body4, 36 boxes, 14x14): see README "Pallas kernels"
    # for numbers; xla wins and is the default.
    tp.ROI_ALIGN_IMPL = "xla"
    # chunk the XLA ROIAlign's [B,O,P,W,C] intermediate into groups of N
    # rois (memory-tight runs); None = single einsum
    tp.ROI_CHUNK = None
    # background the checkpoint serialize+write (atomic tmp+rename; readers
    # join the writer) — false restores the reference's synchronous save
    tp.ASYNC_CHECKPOINT = True
    # donate the TrainState buffers into the jitted step (halves peak state
    # HBM). A/B via tools/profile_step.py --no-donate.
    tp.DONATE_STATE = True
    # wrap the Adam/momentum moment transforms in optax.masked so frozen
    # params carry NO (mu, nu) arrays (~190 MB fp32 saved at base scale:
    # word table + frozen backbone prefix). Updates to frozen params are
    # ALWAYS masked to zero regardless of this knob, so the trained
    # parameters are bit-identical either way. Default false: the full
    # v5e A/B matrix (tools/profile_step.py, 2026-08-18) measured the
    # MaskedState pytree interacting pathologically with buffer donation
    # at small batch — B=4 step 80.8 ms masked vs 37.0 ms dense (2.2x),
    # while B=16 is a wash (109.3 vs 110.3 ms). Set true only when moment
    # HBM is the binding constraint (e.g. FSDP-sharded large runs).
    tp.MASKED_OPT_STATE = False
    return c


def _vcr_config():
    """VCR deltas (ref: vcr/function/config.py)."""
    c = _common_config()
    c.DATASET.LABEL_INDEX_IN_BATCH = 7
    c.NETWORK.PARTIAL_PRETRAIN_SEGMB_INIT = False
    c.NETWORK.IMAGE_SEMANTIC = True
    c.NETWORK.QA_ONE_SENT = False
    c.NETWORK.ENABLE_CNN_REG_LOSS = True
    c.NETWORK.CNN_REG_DROPOUT = 0.0
    c.NETWORK.CNN_LOSS_TOP = False
    c.NETWORK.ANSWER_FIRST = False
    c.NETWORK.LOAD_REL_HEAD = True
    c.NETWORK.VLBERT.object_word_embed_mode = 1
    c.NETWORK.VLBERT.with_pooler = True
    c.TRAIN.VISUAL_SCALE_TEXT_LR_MULT = 1.0
    c.TRAIN.VISUAL_SCALE_OBJECT_LR_MULT = 1.0
    c.TRAIN.VISUAL_SCALE_CLIP_GRAD_NORM = -1
    c.TRAIN.LOSS_LOGGERS = [("ans_loss", "AnsLoss"), ("cnn_regularization_loss", "CNNRegLoss")]
    return c


def _vqa_config():
    """VQA deltas (ref: vqa/function/config.py)."""
    c = _common_config()
    c.DATASET.ANSWER_VOCAB_FILE = ""
    c.DATASET.ANSWER_VOCAB_SIZE = 3129
    c.DATASET.BOXES = "36"  # "36" or "10-100ada"
    c.DATASET.USE_IMDB = True
    c.NETWORK.ANS_LOSS_TYPE = "bce"  # 'bce' or 'ce'
    c.NETWORK.REPLACE_OBJECT_CHANGE_LABEL = True
    c.NETWORK.CLASSIFIER_PRETRAINED = False
    c.TRAIN.VISUAL_SCALE_TEXT_LR_MULT = 1.0
    c.TRAIN.VISUAL_SCALE_OBJECT_LR_MULT = 1.0
    c.TRAIN.VISUAL_SCALE_CLIP_GRAD_NORM = -1
    c.TRAIN.LOSS_LOGGERS = [("ans_loss", "AnsLoss")]
    return c


def _refcoco_config():
    """RefCOCO+ deltas (ref: refcoco/function/config.py)."""
    c = _common_config()
    c.DATASET.ANSWER_VOCAB_FILE = ""
    c.DATASET.ANSWER_VOCAB_SIZE = 3129
    c.DATASET.TRAIN_BOXES = "gt"
    c.DATASET.VAL_BOXES = "gt"
    c.DATASET.TEST_BOXES = "gt"
    c.DATASET.PROPOSAL_SOURCE = "official"
    c.DATASET.USE_IMDB = True
    c.NETWORK.ANS_LOSS_TYPE = "bce"
    c.NETWORK.REPLACE_OBJECT_CHANGE_LABEL = True
    c.NETWORK.CLASSIFIER_PRETRAINED = False
    c.TRAIN.VISUAL_SCALE_TEXT_LR_MULT = 1.0
    c.TRAIN.VISUAL_SCALE_OBJECT_LR_MULT = 1.0
    c.TRAIN.VISUAL_SCALE_CLIP_GRAD_NORM = -1
    c.TRAIN.LOSS_LOGGERS = [("cls_loss", "ClsLoss")]
    return c


def _pretrain_config():
    """Pretrain deltas (ref: pretrain/function/config.py)."""
    c = _common_config()
    c.DATASET.ANSWER_VOCAB_FILE = ""
    c.DATASET.ANSWER_VOCAB_SIZE = 3129
    c.DATASET.SEQ_LEN = 64
    c.DATASET.MIN_SEQ_LEN = 0
    c.NETWORK.VLBERT.from_scratch = False
    c.NETWORK.VLBERT.pos_embedding_frozen = False
    c.NETWORK.VLBERT.visual_region_classes = 1601
    c.NETWORK.WITH_REL_LOSS = True
    c.NETWORK.WITH_MLM_LOSS = True
    c.NETWORK.WITH_MVRC_LOSS = True
    c.NETWORK.MLM_LOSS_NORM_IN_BATCH_FIRST = False
    c.NETWORK.MVRC_LOSS_NORM_IN_BATCH_FIRST = False
    c.NETWORK.MASK_RAW_PIXELS = True
    c.TRAIN.LOSS_LOGGERS = [
        ("relationship_loss", "RelLoss"),
        ("mlm_loss", "MLMLoss"),
        ("mvrc_loss", "MVRCLoss"),
    ]
    return c


TASK_CONFIGS = {
    "vcr": _vcr_config,
    "vqa": _vqa_config,
    "refcoco": _refcoco_config,
    "pretrain": _pretrain_config,
}


def default_config(task):
    try:
        return TASK_CONFIGS[task]()
    except KeyError:
        raise ValueError(f"unknown task {task!r}; one of {sorted(TASK_CONFIGS)}")


def _merge_vlbert(dst, src, path):
    for k, v in src.items():
        if k not in dst:
            raise ValueError(f"key {path}.{k} not in default config")
        dst[k] = v


def update_config(config, config_file, allow_list_dataset=False):
    """Overlay a YAML experiment file onto ``config`` in place (strict keys).

    ref: vcr/function/config.py:174-202; list-DATASET handling from
    pretrain/function/config.py:182-216.
    """
    with open(config_file) as f:
        exp = yaml.safe_load(f)
    if exp is None:
        return config
    for k, v in exp.items():
        if k not in config:
            raise ValueError(f"key {k} not in default config")
        if k == "DATASET" and isinstance(v, list):
            if not allow_list_dataset:
                raise ValueError("list-valued DATASET only supported for pretrain configs")
            templ = config["DATASET"]
            filled = []
            for ds in v:
                entry = templ.clone()
                for dk, dv in ds.items():
                    if dk not in entry:
                        raise ValueError(f"key DATASET.{dk} not in default config")
                    entry[dk] = dv
                filled.append(entry)
            config["DATASET"] = filled
            continue
        if isinstance(v, dict):
            for vk, vv in v.items():
                if vk not in config[k]:
                    raise ValueError(f"key {k}.{vk} not in default config")
                if vk == "LR_STEP":
                    config[k][vk] = tuple(float(s) for s in vv.split(","))
                elif vk == "LOSS_LOGGERS":
                    config[k][vk] = [tuple(str(s) for s in item.split(",")) for item in vv]
                elif vk == "VLBERT" and isinstance(vv, dict):
                    _merge_vlbert(config[k][vk], vv, f"{k}.{vk}")
                else:
                    config[k][vk] = vv
        else:
            if k == "SCALES":
                config[k] = tuple(v)
            else:
                config[k] = v
    return config


def load_config(task, config_file=None):
    """Build the default tree for ``task`` and optionally overlay a YAML file."""
    cfg = default_config(task)
    if config_file is not None:
        update_config(cfg, config_file, allow_list_dataset=(task == "pretrain"))
    return cfg
