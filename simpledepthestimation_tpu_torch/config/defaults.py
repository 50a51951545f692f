"""Canonical default config schema.

Same keys and defaults as ``simpledepthestimation_tpu/config/defaults.py`` so
the yaml files under ``projects/*/configs/`` load under both packages. The
``TPU`` node stays loadable as it is: this package reads only
``TPU.COMPUTE_DTYPE`` from it (models/build.py); the warp-window and conv3d
keys schedule kernels of the JAX package and have no effect here.
The schema is open: project yamls may add keys (e.g. ``LOSS.*``) freely.
"""

from .config import CfgNode as CN

_C = CN()
_C.VERSION = 2

_C.MODEL = CN()
_C.MODEL.META_ARCHITECTURE = ""
_C.MODEL.WEIGHTS = ""
_C.MODEL.PIXEL_MEAN = [0.485, 0.456, 0.406]
_C.MODEL.PIXEL_STD = [0.229, 0.224, 0.225]
_C.MODEL.MAX_DEPTH = 80

_C.MODEL.DEPTH_NET = CN()
_C.MODEL.DEPTH_NET.NAME = ""

_C.MODEL.POSE_NET = CN()
_C.MODEL.POSE_NET.NAME = ""

_C.INPUT = CN()

_C.DATASETS = CN()
_C.DATASETS.TRAIN = CN()
_C.DATASETS.TRAIN.NAME = ""
_C.DATASETS.TRAIN.SPLIT = ""
_C.DATASETS.TRAIN.DATA_ROOT = ""
_C.DATASETS.TRAIN.IMG_WIDTH = 768
_C.DATASETS.TRAIN.IMG_HEIGHT = 384
_C.DATASETS.TRAIN.PREPROCESS = []

_C.DATASETS.TEST = CN()
_C.DATASETS.TEST.NAME = ""
_C.DATASETS.TEST.SPLIT = ""
_C.DATASETS.TEST.DATA_ROOT = ""
_C.DATASETS.TEST.IMG_WIDTH = 768
_C.DATASETS.TEST.IMG_HEIGHT = 384
_C.DATASETS.TEST.PREPROCESS = []

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 6
_C.DATALOADER.SAMPLER_TRAIN = "DDPSampler"
_C.DATALOADER.PREFETCH = 2

_C.LOSS = CN()

_C.SOLVER = CN()
_C.SOLVER.MAX_EPOCHS = 10
_C.SOLVER.DEPTH_LR = 0.001
_C.SOLVER.CHECKPOINT_PERIOD = 1
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.REFERENCE_WORLD_SIZE = 0
_C.SOLVER.GRAD_CLIP = 0.0

_C.TEST = CN()
_C.TEST.EVAL_PERIOD = 1
# Eval batch size. 1 = the reference's timing protocol (data/build.py:130);
# raising it speeds periodic eval when test images share one shape.
_C.TEST.IMS_PER_BATCH = 1
# Overlap periodic eval with the next epoch's training: the epoch-end eval
# runs on a worker thread against a copied params/batch_stats snapshot, and
# its metrics are logged when it finishes (at the next epoch boundary or at
# end of training). Single-process only — under multi-host SPMD two threads
# issuing collectives can interleave differently across processes and
# deadlock, so world_size > 1 ignores this and evals synchronously.
_C.TEST.ASYNC = False
_C.TEST.GT_SCALE = False
_C.TEST.MIN_DEPTH = 0.001
_C.TEST.MAX_DEPTH = 80.0
# True-average BN statistics recompute before each eval (reference
# detectron2/engine/hooks.py:381-450); DefaultTrainer path only.
_C.TEST.PRECISE_BN = CN()
_C.TEST.PRECISE_BN.ENABLED = False
_C.TEST.PRECISE_BN.NUM_ITER = 200

_C.EVALUATORS = ("",)

# ---------------------------------------------------------------------------
# Runtime node shared with the JAX package. Only COMPUTE_DTYPE is read by this
# package; the other keys are kept so shared yaml files and override lists load.
# ---------------------------------------------------------------------------
_C.TPU = CN()
_C.TPU.MESH_AXES = ("data",)
_C.TPU.MESH_SHAPE = (0,)
# Compute dtype of the convolutions ("bfloat16" or "float32"). Params stay fp32.
_C.TPU.COMPUTE_DTYPE = "bfloat16"
_C.TPU.DONATE = True
_C.TPU.REMAT = False
# Warp / conv3d scheduling keys of the JAX package's TPU kernels (unused here).
_C.TPU.WARP_IMPL = "auto"
_C.TPU.WARP_WINDOW = 128
_C.TPU.WARP_XWIN = 512
_C.TPU.WARP_YWIN = 96
_C.TPU.WARP_YWIN_NARROW = 48
_C.TPU.WARP_YWIN_BWD = 0
_C.TPU.WARP_TILE_H = 8
_C.TPU.CONV3D_IMPL = "auto"
_C.TPU.CONV3D_BLOCK = 30

# Strict reference-parity mode: restores reference behaviors behind our
# intentional divergences so a metric gap can be bisected — batch-level flip
# taken from sample 0 (reference data/datasets/kitti_v2.py:219) and a
# synchronous per-step NaN check (reference engine/train_loop.py:283-287)
# instead of the deferred watchdog.
_C.PARITY = CN()
_C.PARITY.STRICT = False

_C.OUTPUT_DIR = "./output"
_C.SEED = -1
_C.VIS_PERIOD = 0
_C.LOG_PERIOD = 20
_C.RUN_NAME = ""

_C.GLOBAL = CN()
_C.GLOBAL.HACK = 1.0
