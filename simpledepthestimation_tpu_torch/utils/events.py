"""Metric storage and writers.

The port's copy of ``simpledepthestimation_tpu/utils/events.py``: a
stack-scoped ``EventStorage`` of smoothed scalar histories, images and
histograms, drained by ``JSONWriter``, ``TensorboardWriter`` and
``CommonMetricPrinter``. Values are converted to Python floats when they are
put: the runtime hands over floats it has already read from the device.
``TensorboardWriter`` needs the ``tensorboard`` package; build it through
:func:`tensorboard_writer_or_none`, which warns once and returns ``None``
where the package is missing. Only a ``TensorboardWriter`` takes images and
histograms, so a write round goes through :func:`write_all`, which drops them
after the writers have written: without tensorboard they would otherwise pile
up in the storage for the length of a run.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .colormap import magma

_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    assert _CURRENT_STORAGE_STACK, "get_event_storage() called outside an EventStorage context"
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """Ring buffer of (value, iteration) pairs with windowed statistics."""

    def __init__(self, max_length: int = 1000000):
        self._max_length = max_length
        self._data: List[Tuple[float, float]] = []
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: Optional[float] = None) -> None:
        if iteration is None:
            iteration = self._count
        if len(self._data) == self._max_length:
            self._data.pop(0)
        self._data.append((value, iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def median(self, window_size: int) -> float:
        return float(np.median([x[0] for x in self._data[-window_size:]]))

    def avg(self, window_size: int) -> float:
        return float(np.mean([x[0] for x in self._data[-window_size:]]))

    def global_avg(self) -> float:
        return self._global_avg

    def values(self) -> List[Tuple[float, float]]:
        return self._data


class EventStorage:
    """Scoped store of the scalars produced during training."""

    def __init__(self, start_iter: int = 0):
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_scalars: Dict[str, Tuple[float, int]] = {}
        self._iter = start_iter
        self._epoch = 0
        self._max_epoch = 0
        self._max_iter_per_epoch = 0
        self._vis_data: List[Tuple[str, np.ndarray, int]] = []
        self._histograms: List[dict] = []

    # -- scalars -----------------------------------------------------------
    def put_scalar(self, name: str, value, smoothing_hint: bool = True) -> None:
        value = float(np.asarray(value))
        self._history[name].update(value, self._iter)
        self._latest_scalars[name] = (value, self._iter)
        existing = self._smoothing_hints.get(name)
        if existing is not None:
            assert existing == smoothing_hint, f"Inconsistent smoothing for {name}"
        else:
            self._smoothing_hints[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint: bool = True, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint=smoothing_hint)

    # -- images and histograms ------------------------------------------------
    def put_image(self, img_name: str, img: np.ndarray) -> None:
        """``img``: [H, W, C] or [C, H, W], uint8 or float."""
        self._vis_data.append((img_name, np.asarray(img), self._iter))

    def put_image_with_cmap(self, img_name: str, img: np.ndarray, cmap: str = "magma") -> None:
        """A one-channel map scaled to [0, 1] and coloured, as uint8 [H, W, 3]
        equal to the JAX package's matplotlib rendering (``utils/colormap.py``)."""
        if cmap != "magma":
            raise ValueError(f"only the magma colormap is carried without matplotlib, not {cmap!r}")
        arr = np.asarray(img).squeeze().astype(np.float64)
        rng = arr.max() - arr.min()
        arr = (arr - arr.min()) / (rng + 1e-12)
        self.put_image(img_name, (magma(arr) * 255).astype(np.uint8))

    def put_histogram(self, hist_name: str, values: np.ndarray, bins: int = 1000) -> None:
        values = np.asarray(values).reshape(-1)
        counts, edges = np.histogram(values, bins=bins)
        self._histograms.append(dict(name=hist_name, counts=counts, edges=edges, iter=self._iter))

    def clear_images(self) -> None:
        self._vis_data = []

    def clear_histograms(self) -> None:
        self._histograms = []

    # -- access ------------------------------------------------------------
    def history(self, name: str) -> HistoryBuffer:
        if name not in self._history:
            raise KeyError(f"No history metric {name}")
        return self._history[name]

    def histories(self) -> Dict[str, HistoryBuffer]:
        return self._history

    def latest_with_smoothing_hint(self, window_size: int = 20) -> Dict[str, Tuple[float, int]]:
        result = {}
        for k, (v, itr) in self._latest_scalars.items():
            result[k] = (
                self._history[k].median(window_size) if self._smoothing_hints[k] else v,
                itr,
            )
        return result

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, val: int) -> None:
        self._iter = int(val)

    @property
    def epoch(self) -> int:
        return self._epoch

    @epoch.setter
    def epoch(self, val: int) -> None:
        self._epoch = int(val)

    @property
    def max_epoch(self) -> int:
        return self._max_epoch

    @max_epoch.setter
    def max_epoch(self, val: int) -> None:
        self._max_epoch = int(val)

    @property
    def max_iter_per_epoch(self) -> int:
        return self._max_iter_per_epoch

    @max_iter_per_epoch.setter
    def max_iter_per_epoch(self, val: int) -> None:
        self._max_iter_per_epoch = int(val)

    def __enter__(self) -> "EventStorage":
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, *args) -> None:
        assert _CURRENT_STORAGE_STACK[-1] is self
        _CURRENT_STORAGE_STACK.pop()


class EventWriter:
    def write(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONWriter(EventWriter):
    """One json dict per line, written every call (reference events.py:52-131)."""

    def __init__(self, json_file: str, window_size: int = 20):
        os.makedirs(os.path.dirname(os.path.abspath(json_file)), exist_ok=True)
        self._file = open(json_file, "a")
        self._window_size = window_size
        self._last_write = -1

    def write(self) -> None:
        storage = get_event_storage()
        to_save = defaultdict(dict)
        for k, (v, itr) in storage.latest_with_smoothing_hint(self._window_size).items():
            if itr <= self._last_write:
                continue
            to_save[itr][k] = v
        if to_save:
            self._last_write = max(to_save.keys())
        for itr, scalars in sorted(to_save.items()):
            scalars["iteration"] = itr
            self._file.write(json.dumps(scalars, sort_keys=True) + "\n")
        self._file.flush()
        try:
            os.fsync(self._file.fileno())
        except OSError:
            pass

    def close(self) -> None:
        self._file.close()


class TensorboardWriter(EventWriter):
    """Scalars, images and histograms to tensorboard."""

    def __init__(self, log_dir: str, window_size: int = 20, **kwargs):
        self._window_size = window_size
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir, **kwargs)
        self._last_write = -1

    def write(self) -> None:
        storage = get_event_storage()
        new_last_write = self._last_write
        for k, (v, itr) in storage.latest_with_smoothing_hint(self._window_size).items():
            if itr > self._last_write:
                self._writer.add_scalar(k, v, itr)
                new_last_write = max(new_last_write, itr)
        self._last_write = new_last_write

        for img_name, img, step_num in storage._vis_data:
            dataformats = "HWC" if img.ndim == 3 and img.shape[-1] in (1, 3, 4) else "CHW"
            self._writer.add_image(img_name, img, step_num, dataformats=dataformats)
        storage.clear_images()

        for params in storage._histograms:
            self._writer.add_histogram_raw(
                tag=params["name"],
                min=float(params["edges"][0]),
                max=float(params["edges"][-1]),
                num=int(params["counts"].sum()),
                sum=0.0,
                sum_squares=0.0,
                bucket_limits=params["edges"][1:].tolist(),
                bucket_counts=params["counts"].tolist(),
                global_step=params["iter"],
            )
        storage.clear_histograms()

    def close(self) -> None:
        if hasattr(self, "_writer"):
            self._writer.close()


class CommonMetricPrinter(EventWriter):
    """Console line `[epoch/max][iter/max] losses time data_time lr eta`
    (reference events.py:184-269)."""

    def __init__(self, max_iter: Optional[int] = None, window_size: int = 20):
        self.logger = logging.getLogger(__name__)
        self._max_iter = max_iter
        self._window_size = window_size
        self._last_write: Optional[Tuple[int, float]] = None

    def _get_eta(self, storage) -> Optional[str]:
        if self._max_iter is None:
            return None
        iteration = storage.iter
        try:
            eta_seconds = storage.history("time").median(1000) * (self._max_iter - iteration - 1)
            return str(datetime.timedelta(seconds=int(eta_seconds)))
        except KeyError:
            pass
        eta_string = None
        if self._last_write is not None:
            estimate_iter_time = (time.perf_counter() - self._last_write[1]) / max(
                storage.iter - self._last_write[0], 1
            )
            eta_seconds = estimate_iter_time * (self._max_iter - storage.iter - 1)
            eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
        self._last_write = (storage.iter, time.perf_counter())
        return eta_string

    def write(self) -> None:
        storage = get_event_storage()
        iteration = storage.iter
        if iteration == self._max_iter:
            return

        try:
            data_time = storage.history("data_time").avg(self._window_size)
        except KeyError:
            data_time = None
        try:
            iter_time = storage.history("time").global_avg()
        except KeyError:
            iter_time = None
        try:
            lr = "{:.2e}".format(storage.history("lr").latest())
        except KeyError:
            lr = "N/A"

        eta_string = self._get_eta(storage)

        losses = "  ".join(
            f"{k}: {v.median(self._window_size):.4g}"
            for k, v in storage.histories().items()
            if "loss" in k
        )
        epoch_str = (
            f"[{storage.epoch}/{storage.max_epoch}]" if storage.max_epoch else ""
        )
        iter_str = (
            f"[{iteration % storage.max_iter_per_epoch}/{storage.max_iter_per_epoch}]"
            if storage.max_iter_per_epoch
            else f"iter: {iteration}"
        )
        self.logger.info(
            " {eta}{epoch}{it}  {losses}  {time}{data_time}lr: {lr}".format(
                eta=f"eta: {eta_string}  " if eta_string else "",
                epoch=epoch_str,
                it=iter_str,
                losses=losses,
                time=f"time: {iter_time:.4f}  " if iter_time is not None else "",
                data_time=f"data_time: {data_time:.4f}  " if data_time is not None else "",
                lr=lr,
            )
        )


_TENSORBOARD_WARNED = False


def tensorboard_writer_or_none(log_dir: str, **kwargs) -> Optional[TensorboardWriter]:
    """A ``TensorboardWriter`` where ``torch.utils.tensorboard`` imports; else
    ``None``, with one warning per process (the JSON and console writers do
    not need the package)."""
    global _TENSORBOARD_WARNED
    try:
        return TensorboardWriter(log_dir, **kwargs)
    except ImportError as e:
        if not _TENSORBOARD_WARNED:
            _TENSORBOARD_WARNED = True
            warnings.warn(f"tensorboard is not available ({e}); writing metrics.json and the console only")
        return None


def write_all(writers) -> None:
    """One write round: each writer writes, then the storage's images and
    histograms are dropped (a ``TensorboardWriter`` has taken them; with none,
    nothing would)."""
    for writer in writers:
        writer.write()
    storage = get_event_storage()
    storage.clear_images()
    storage.clear_histograms()
