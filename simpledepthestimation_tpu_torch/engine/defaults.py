"""Command line, run set-up and the ``simple_main`` glue of the entry points.

The port's counterpart of ``simpledepthestimation_tpu/engine/defaults.py``:
the same ``--cfg``, ``--resume``, ``--eval`` and trailing ``KEY VALUE``
overrides, ``RUN_NAME`` from the config's path (``{project}_{cfgname}``),
``OUTPUT_DIR`` nested under it, the merged config written to
``OUTPUT_DIR/config.yaml`` and the log to ``OUTPUT_DIR/log.txt``. One more
argument, ``--device`` (the card by default; ``cpu`` for a run on the CPU),
takes the place of the JAX package's ``JAX_PLATFORMS`` handling.

Several processes: ``--coordinator host:port --num-processes N --process-id
i`` start one process of N (:func:`maybe_init_distributed`), one per card
(consecutive ids on one host take consecutive cards) or, with ``--device
cpu``, on the CPU; the coordinator is process 0's address. NCCL joins the
cards, gloo the CPU processes.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Callable, Optional

import torch

from ..config import CfgNode, get_cfg
from ..models.build import resolve_device
from ..utils import comm
from ..utils.env import collect_env_info, seed_all_rng
from ..utils.events import CommonMetricPrinter, JSONWriter, tensorboard_writer_or_none
from ..utils.logger import setup_logger

logger = logging.getLogger(__name__)


def default_argument_parser(epilog: Optional[str] = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        epilog=epilog or "Example:  python projects/MonoDepth2/train_torch.py "
                         "--cfg projects/MonoDepth2/configs/synthetic_quick.yaml",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--cfg", default="", metavar="FILE", help="path to config file")
    parser.add_argument("--resume", action="store_true", help="resume from the checkpoint directory (if any)")
    parser.add_argument("--eval", action="store_true", help="evaluate only")
    parser.add_argument("--device", default="cuda", help="torch device to run on (default: the CUDA card)")
    parser.add_argument("--coordinator", default="",
                        help="host:port of process 0, where the processes of a multi-process run meet")
    parser.add_argument("--num-processes", type=int, default=1, help="number of processes, one per card")
    parser.add_argument("--process-id", type=int, default=0, help="this process's index, 0 .. num-processes - 1")
    parser.add_argument(
        "opts", help="Modify config options at the end of the command: KEY VALUE pairs",
        default=None, nargs=argparse.REMAINDER,
    )
    return parser


def maybe_init_distributed(args) -> torch.device:
    """The device of this process, and the process group of a run of several
    (``--coordinator`` and ``--num-processes`` above 1): NCCL on CUDA, after
    ``torch.cuda.set_device`` of this process's card
    (:func:`..utils.comm.local_rank_of`), gloo on the CPU. A group that the
    caller made already is kept. Without a CUDA device ``--device cuda``
    raises, as on one process."""
    device = resolve_device(args.device)
    if args.num_processes > 1 and not args.coordinator:
        raise ValueError(f"--num-processes {args.num_processes} needs --coordinator host:port (process 0's)")
    if not (args.coordinator and args.num_processes > 1) or comm.is_initialized():
        return device
    if not 0 <= args.process_id < args.num_processes:
        raise ValueError(f"--process-id {args.process_id} is not in 0 .. {args.num_processes - 1}")
    if device.type == "cuda":
        device = torch.device("cuda", comm.local_rank_of(args.process_id))
        torch.cuda.set_device(device)
    comm.init_process_group(f"tcp://{args.coordinator}", world_size=args.num_processes, rank=args.process_id,
                            backend="nccl" if device.type == "cuda" else "gloo")
    return device


def assemble_cfg(args) -> CfgNode:
    """Merge defaults ← cfg file ← CLI opts; derive RUN_NAME / OUTPUT_DIR."""
    cfg = get_cfg()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
    if args.opts:
        # argparse REMAINDER keeps a literal '--' separator: strip it
        opts = list(args.opts)
        if opts and opts[0] == "--":
            opts = opts[1:]
        args.opts = opts
        flags = [o for o in args.opts if isinstance(o, str) and o.startswith("--")]
        if flags:
            raise SystemExit(
                f"Flags {flags} appeared after KEY VALUE overrides; place "
                "--resume/--eval/--device etc. BEFORE the trailing config overrides."
            )
        cfg.merge_from_list(list(args.opts))

    if not cfg.RUN_NAME:
        if args.cfg:
            cfg_path = os.path.abspath(args.cfg)
            project = os.path.basename(os.path.dirname(os.path.dirname(cfg_path)))
            cfg_name = os.path.splitext(os.path.basename(cfg_path))[0]
            cfg.RUN_NAME = f"{project}_{cfg_name}"
        else:
            cfg.RUN_NAME = "run"
    cfg.OUTPUT_DIR = os.path.join(cfg.OUTPUT_DIR, cfg.RUN_NAME)
    cfg.freeze()
    return cfg


def default_setup(cfg: CfgNode, args=None) -> None:
    """Make ``OUTPUT_DIR``, set up the logger (console and ``log.txt``), log the
    environment, write ``config.yaml`` and seed the global generators."""
    output_dir = cfg.OUTPUT_DIR
    if comm.is_main_process() and output_dir:
        os.makedirs(output_dir, exist_ok=True)

    rank = comm.get_rank()
    setup_logger(output_dir, distributed_rank=rank)
    logger.info(f"Process rank {rank} / world size {comm.get_world_size()}")
    logger.info("Environment info:\n" + collect_env_info())
    if args is not None:
        logger.info(f"Command line arguments: {args}")

    if comm.is_main_process() and output_dir:
        path = os.path.join(output_dir, "config.yaml")
        with open(path, "w") as f:
            f.write(cfg.dump())
        logger.info(f"Full config saved to {path}")

    seed = cfg.SEED
    seed_all_rng(None if seed < 0 else seed + rank)


def default_writers(output_dir: str, max_iter: Optional[int] = None):
    """Console, ``metrics.json`` and (where the package is installed) tensorboard."""
    writers = [CommonMetricPrinter(max_iter), JSONWriter(os.path.join(output_dir, "metrics.json"))]
    tensorboard = tensorboard_writer_or_none(output_dir)
    return writers + ([tensorboard] if tensorboard is not None else [])


def simple_main(args, train_fn: Callable, test_fn: Optional[Callable] = None):
    """Process group (several processes) → cfg assembly → set-up → evaluation
    alone (``--eval``) or training. ``train_fn`` and ``test_fn`` take
    ``(cfg, resume=, device=)``."""
    device = maybe_init_distributed(args)
    cfg = assemble_cfg(args)
    default_setup(cfg, args)
    if args.eval and test_fn is not None:
        return test_fn(cfg, resume=args.resume, device=device)
    return train_fn(cfg, resume=args.resume, device=device)
