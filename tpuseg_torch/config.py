"""Typed, immutable configuration tree.

Replaces the reference's global mutable-then-frozen ``AttrDict`` cfg +
~90-flag argparse soup (reference: config.py:47-383, train.py:62-271) with
plain frozen dataclasses. There is no global state: a ``Config`` instance is
constructed once (from YAML/CLI or in code) and passed explicitly. Values
that the reference mutates mid-run (``cfg.EPOCH`` for label relaxation,
config.py:364-368) are instead carried as explicit step state in the train
loop.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


def _freeze(value):
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    return value


@dataclass(frozen=True)
class DatasetConfig:
    """Dataset selection and host-pipeline knobs (reference: config.py:76-117)."""

    name: str = "cityscapes"
    num_classes: int = 19
    ignore_label: int = 255
    # ImageNet normalization, shared by all trunks (reference: config.py:96-97)
    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)
    # uint8 wire format: loaders emit raw uint8 pixels / uint8 labels and
    # the jitted graphs normalize on device (tpuseg/ops/normalize.py) —
    # 4x fewer host->device bytes, arithmetic identical to host
    # normalization. Off by default so library batches stay float32;
    # every shipped recipe turns it on. Requires ignore_label <= 255.
    transfer_uint8: bool = False
    crop_size: Sequence[int] = (1024, 2048)  # (H, W)
    # class-uniform sampling (reference: config.py:102-103, datasets/uniform.py)
    class_uniform_pct: float = 0.5
    class_uniform_tile: int = 1024
    coarse_boost_classes: Sequence[int] | None = None
    custom_coarse_prob: float | None = None
    # classes whose auto-labelled (custom-coarse) pixels are overridden by
    # the human gtCoarse annotation when one exists (reference
    # --custom_coarse_dropout_classes -> cfg.DROPOUT_COARSE_BOOST_CLASSES:
    # config.py:351-354, datasets/base_loader.py:177-183)
    custom_coarse_dropout_classes: Sequence[int] | None = None
    # train ONLY on the coarse set (reference --only_coarse:
    # train.py:434-437, datasets/cityscapes.py:175-180)
    only_coarse: bool = False
    cv: int = 0
    cv_splits: int = 3
    # data roots
    cityscapes_dir: str = ""
    cityscapes_customcoarse: str = ""
    mapillary_dir: str = ""
    centroid_root: str = ""
    translate_aug_fix: bool = False
    mapillary_crop_val: bool = False
    mask_out_cityscapes: bool = False  # ego-vehicle drop mask on pseudo-labels
    dump_images: bool = False
    # augmentation knobs (reference: train.py args --scale_min/--scale_max/
    # --pre_size/--color_aug/--gblur/--bblur/--rand_augment)
    scale_min: float = 0.5
    scale_max: float = 2.0
    pre_size: int | None = None
    full_crop_training: bool = False
    color_aug: float = 0.25
    gblur: bool = False
    bblur: bool = False
    rand_augment: Sequence[int] | None = None  # (N, M)
    jointwtborder: bool = False
    # host pipeline
    num_workers: int = 8
    # host input pipeline: 'threaded' (BatchLoader, thread prefetch) or
    # 'grain' (worker PROCESSES via Google Grain — use when augmentation
    # is CPU-bound at large crops)
    loader: str = "threaded"
    eval_folder: str | None = None


@dataclass(frozen=True)
class OCRConfig:
    """OCR head channel widths (reference: config.py:158-160)."""

    mid_channels: int = 512
    key_channels: int = 256
    # SpatialOCR bottleneck dropout (reference: ocrnet.py:64, 0.05); the
    # train-parity oracle sets 0 for a deterministic comparison
    dropout: float = 0.05


@dataclass(frozen=True)
class ModelConfig:
    """Architecture + numeric-policy knobs (reference: config.py:119-148).

    ``arch`` strings follow the reference registry convention
    ("ocrnet.HRNet_Mscale", "deepv3.DeepWV3Plus", ... —
    network/__init__.py:45-54); resolution happens in
    :mod:`tpuseg.models`.
    """

    arch: str = "ocrnet.HRNet_Mscale"
    ocr: OCRConfig = field(default_factory=OCRConfig)
    # bilinear resize convention, global (reference: config.py:127)
    align_corners: bool = False
    # multi-scale attention
    mscale_lo_scale: float = 0.5      # train-time low scale (config.py:128)
    n_scales: Sequence[float] | None = None  # inference scales (config.py:126)
    mscale_inner_3x3: bool = True     # extra 3x3 in attn head (config.py:133)
    mscale_dropout: bool = False      # dropout in attn head (config.py:134)
    # legacy zero-init attention head (reference --mscale_old_arch:
    # config.py:324-325, network/utils.py:370-381)
    mscale_old_arch: bool = False
    # NOTE: the four knobs below are intentionally dead, faithful to flags
    # the reference also defines but never reads (set in reference
    # config.py:123-136, consumed nowhere) — kept so recipes round-trip
    mscale_init: float = 0.5          # initial attention bias (config.py:136)
    mscale_cat_scale_flt: bool = False
    three_scale: bool = False
    alt_two_scale: bool = False
    ocr_aspp: bool = False            # ASPP inside OCR (config.py:129)
    segattn_bot_ch: int = 256         # seg/attn head bottleneck (config.py:130)
    aspp_bot_ch: int = 256            # ASPP bottleneck (config.py:131)
    attnscale_bn_head: bool = False
    # dead like the four above: reference sets MODEL.EXTRA_SCALES
    # (config.py:289-290) but eval reads args.extra_scales directly
    # (trnval_utils.py:97) — the live knob here is eval.extra_scales
    extra_scales: Sequence[float] = (0.5, 1.5)
    # read by neither package (reference: config.py:216-225): batch
    # statistics are global across data-parallel ranks whatever it says
    # (tpuseg's mesh makes them so; here models/layers.py::BatchNorm2d)
    sync_bn: bool = True
    bn_momentum: float = 0.9          # flax convention: ema = m*ema + (1-m)*batch
    bn_eps: float = 1e-5
    # numeric policy: params in f32, compute in bf16 (replaces apex AMP O1,
    # reference: train.py:380-381). Per-op f32 islands are hard-coded where
    # the reference used @amp.float_function (resize, attention softmax).
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # eval-time fusion-chain dtype: float32 = exact reference parity;
    # bfloat16 trades <0.1 mIoU for halved full-res HBM traffic
    eval_fusion_dtype: str = "float32"
    # rematerialization of trunk stages — the reference's dead --grad_ckpt
    # flag (config.py:355-356) made live: needed for 1024x2048 crops.
    remat: bool = True
    # selective remat (HRNet trunk): remat only these stage numbers,
    # keeping the excluded stages' activations resident — skips their
    # backward recompute at the cost of activation memory. None = all
    # stages when remat is on. E.g. (1, 2, 3) skips recomputing stage 4.
    remat_stages: Sequence[int] | None = None
    # opt-in fused Pallas OCR attention kernel; off by default — measured
    # on v5e, XLA's own fusion wins for this op and it is <1% of pipeline
    # time (tpuseg/models/ocr.py:ObjectAttention docstring)
    use_pallas: bool = False
    # opt-in fused stage-1 Bottleneck Pallas megakernel (inference only;
    # tpuseg/kernels/bottleneck_fused.py). Off by default — measured on
    # v5e (tools/bench_megakernel.py): XLA's three-conv compilation wins
    # at 0.68-0.70x kernel/XLA; per-tile DMA serialization eats the
    # traffic savings and larger tiles exceed VMEM (docs/ROOFLINE.md).
    # Shapes that don't tile (H%64 or W%512 of input res) silently take
    # the XLA path either way. Plumbed through every zoo model; it only
    # has an effect when the model's trunk is hrnetv2 (the kernel targets
    # the HRNet stage-1 Bottleneck) — other trunks ignore it.
    fused_stage1: bool = False


@dataclass(frozen=True)
class LossConfig:
    """Loss selection + weights (reference: config.py:150-156, loss/utils.py:40-67)."""

    loss_type: str = "ce"             # ce | rmi | img_wt | relaxed
    ocr_alpha: float = 0.4            # aux-loss weight (config.py:152)
    ocr_aux_rmi: bool = False         # use RMI for aux loss (config.py:154)
    supervised_mscale_wt: float = 0.0  # direct mscale supervision (config.py:156)
    img_wt_bound: float = 1.0         # upper bound for image-weighted CE
    batch_weighting: bool = False     # batch (vs per-image) class weighting
    # label relaxation (reference: config.py:55-62)
    border_window: int = 1
    reduce_border_epoch: int = -1
    strict_border_classes: Sequence[int] | None = None
    # RMI numerics: TPU has no f64; the covariance/Cholesky path runs in f32
    # with a larger diagonal jitter (validated in tests/test_rmi.py).
    rmi_radius: int = 3
    rmi_pool_size: int = 4


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer + LR schedule (reference: loss/optimizer.py:43-98)."""

    optimizer: str = "sgd"            # sgd | adam | radam
    lr: float = 5e-3
    momentum: float = 0.9
    weight_decay: float = 1e-4
    amsgrad: bool = False
    lr_schedule: str = "poly"         # poly | poly2 | scl-poly
    poly_exp: float = 2.0
    poly_step: int = 110              # for scl-poly warm restart
    rescale_lr: float = 1.0
    # post-restart poly exponent for scl-poly (reference --repoly:
    # train.py:104-105, loss/optimizer.py:83-87)
    repoly: float = 1.5


@dataclass(frozen=True)
class TrainConfig:
    max_epoch: int = 175
    # stop class-uniform/coarse sampling after this epoch: the tail of
    # training sees the natural fine distribution (reference --max_cu_epoch:
    # train.py:439-445, datasets/cityscapes.py:169-173)
    max_cu_epoch: int = 150
    batch_size: int = 8               # global batch (split across data axis)
    val_freq: int = 1
    seed: int = 0
    log_every: int = 20
    # checkpointing
    checkpoint_dir: str = "ckpt"
    keep_checkpoints: int = 2
    resume: str | None = None         # full resume: params+opt+epoch
    snapshot: str | None = None       # weights-only warm start
    test_mode: bool = False           # truncate epochs/iters for smoke tests
    # capture a torch.profiler host and device trace of this many steps
    # at the start of the first epoch, after its first step (cuDNN's
    # algorithm choice); written to <logdir>/trace as a Chrome trace
    # (Perfetto) that carries the program's layer spans
    # (utils/profiling.py SPANS). 0 = off. (The reference has only
    # wall-clock batch timing, train.py:478-516)
    profile_steps: int = 0


@dataclass(frozen=True)
class EvalConfig:
    """Inference-time options (reference: utils/trnval_utils.py:82-198)."""

    scales: Sequence[float] = (0.5, 1.0, 2.0)
    # validation batch size (reference --bs_val, train.py / datasets/
    # __init__.py:192). >1 requires a fixed-resolution val set (Cityscapes:
    # 1024x2048) so batches stack; metrics are bit-identical to bs=1 (the
    # confusion matrix is additive over images) while amortizing per-batch
    # dispatch through the device relay. Keep 1 for variable-size val
    # (Mapillary without eval.pad_multiple).
    batch_size: int = 1
    do_flip: bool = False
    # extra avg-pooled scales applied *outside* the attention fusion
    extra_scales: Sequence[float] = ()
    # primary scale for per-scale IoU reporting when extra_scales are on
    # (reference --default_scale/--log_msinf_to_tb: train.py:188-193,
    # utils/misc.py:118-132); per-scale tables logged when extra_scales set
    default_scale: float = 1.0
    # run eval without scoring (reference --no_metrics: train.py:265-266)
    no_metrics: bool = False
    dump_assets: bool = False
    dump_all_images: bool = False
    dump_for_auto_labelling: bool = False
    dump_for_submission: bool = False
    result_dir: str | None = None
    # bucket variable-size val images by padding H/W to this multiple
    # (one compiled graph per bucket instead of per exact shape); None =
    # exact shapes (reference behavior)
    pad_multiple: int | None = None
    # dump the top-N worst-performing val images per class, with an HTML
    # failure gallery (reference --dump_topn/--dump_topn_all:
    # train.py:163-168, utils/trnval_utils.py:201-348); 0 = off
    dump_topn: int = 0
    dump_topn_all: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. The reference has DP only (SURVEY §2.8); we keep a
    named `data` axis, with room for a `model` axis for spatial sharding."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallelism: int = 1


@dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _apply_overrides(obj, overrides: Mapping[str, Any]):
    """Apply a flat {'a.b.c': v} or nested {'a': {'b': v}} override mapping."""
    updates: dict[str, Any] = {}
    nested: dict[str, dict] = {}
    for key, val in overrides.items():
        if "." in key:
            head, rest = key.split(".", 1)
            nested.setdefault(head, {})[rest] = val
        elif isinstance(val, Mapping) and dataclasses.is_dataclass(
            getattr(obj, key, None)
        ):
            nested.setdefault(key, {}).update(val)
        else:
            updates[key] = _freeze(val)
    for head, sub in nested.items():
        updates[head] = _apply_overrides(getattr(obj, head), sub)
    return dataclasses.replace(obj, **updates)


def make_config(overrides: Mapping[str, Any] | None = None) -> Config:
    """Build a Config with optional dotted-path overrides.

    >>> cfg = make_config({"model.arch": "deepv3.DeepWV3Plus", "optim.lr": 1e-2})
    """
    cfg = Config()
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    if cfg.dataset.transfer_uint8 and not (
            cfg.dataset.ignore_label <= 255
            and cfg.dataset.num_classes <= 255):
        raise ValueError(
            "dataset.transfer_uint8 needs labels + ignore_label to fit in "
            f"a byte; got num_classes={cfg.dataset.num_classes}, "
            f"ignore_label={cfg.dataset.ignore_label}")
    return cfg


def infer_mscale(cfg: Config) -> bool:
    """Whether the arch is a multi-scale-attention model
    (reference: config.py:269-270)."""
    arch = cfg.model.arch.lower()
    return "mscale" in arch or "attnscale" in arch


def eval_model_config(cfg: Config) -> Config:
    """Config for building the EVAL model: mscale archs with no explicit
    ``model.n_scales`` run n-scale fusion over ``eval.scales`` (reference
    promotes via ``--n_scales`` sharing INFERENCE_SCALES semantics,
    train.py:243-247 / config.py:126). Used by the Trainer, evaluate_only,
    and the serving exporter — the exported graph must be the same one
    eval runs."""
    if infer_mscale(cfg) and not cfg.model.n_scales:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, n_scales=tuple(cfg.eval.scales)))
    return cfg
