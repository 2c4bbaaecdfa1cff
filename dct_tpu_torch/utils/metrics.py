"""Metrics (the port's copy of ``dct_tpu.utils.metrics``): the codec's
metric vocabulary (MSE, PSNR, RLE ratio, compression ratio) plus
throughput timing on the card.

Formulas, as the reference package states them:
  * MSE: the mean of the float64 squared differences
  * PSNR = 10*log10(255^2 / MSE), infinite for identical images
  * RLE ratio = N^2 / symbol_count
  * compression ratio = raw_bytes / encoded_bytes

The image metrics take numpy arrays or torch tensors (on any device: a
tensor is copied to the host first). The timers use CUDA events when the
timed work runs on the card and the host clock otherwise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A numpy array of ``a``, a host array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def mse(a, b) -> float:
    return float(np.mean((_host(a) - _host(b)) ** 2))


def psnr(a, b, peak: float = 255.0) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))


def rle_ratio(n2: int, symbol_count: int) -> float:
    return n2 / max(symbol_count, 1)


def compression_ratio(raw_bytes: int, encoded_bytes: int) -> float:
    return raw_bytes / max(encoded_bytes, 1)


@dataclass
class Throughput:
    mpix_per_s: float
    seconds_per_frame: float
    pixels: int
    iters: int


def _tensors(out):
    """Every tensor in a function's output: a tensor, or nested tuples and
    lists of them (e.g. codec.encode_step's result)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def _on_card(out) -> bool:
    return any(t.device.type == "cuda" for t in _tensors(out))


def seconds_per_call(fn, iters: int, on_card: bool) -> float:
    """Mean seconds of ``iters`` calls of fn(): CUDA events around them,
    then a synchronise, on the card; the host clock otherwise."""
    if on_card:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def measure_throughput(fn, *args, iters: int = 20, warmup: int = 3,
                       pixels: int = 0) -> Throughput:
    """Time fn(*args): the mean over ``iters`` calls after ``warmup``
    calls (at least one: its output says where the work runs). When the
    output holds a CUDA tensor the calls are timed by CUDA events and a
    synchronise; otherwise by the host clock."""
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    dt = seconds_per_call(lambda: fn(*args), iters, _on_card(out))
    return Throughput(
        mpix_per_s=pixels / dt / 1e6 if pixels else 0.0,
        seconds_per_frame=dt,
        pixels=pixels,
        iters=iters,
    )


def kloop_delta_seconds(make_step, operand, k: int = 9, iters: int = 5):
    """Seconds per body execution, with the fixed cost of a call taken out.

    ``make_step(k)`` must return a callable that runs its body k times,
    each trip on DISTINCT data (so no trip repeats another's work), and
    returns a scalar tensor. The trip counts 1 and k are timed, each by
    CUDA events around ``iters`` calls when the scalar lies on the card
    (by the host clock otherwise), after a warm-up call; the delta
    cancels the fixed per-call cost on the host (argument handling, kernel
    launches, the final reduction). Returns (seconds_per_body,
    noise_dominated): if the delta is non-positive the single-trip time
    is returned with the flag set — callers should report, not hide, that
    condition.
    """
    r1, rk = make_step(1), make_step(k)

    def timed(fn):
        on_card = _on_card(fn(operand))  # warm-up (builds, caches)
        return seconds_per_call(lambda: fn(operand), iters, on_card)

    t1, tk = timed(r1), timed(rk)
    if tk <= t1:
        return t1, True
    return (tk - t1) / (k - 1), False
