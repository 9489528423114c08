"""The sign-compressed all-reduce with error feedback of the 1-bit
optimizers (counterpart of ``deepspeed_tpu/runtime/comm/compressed.py``).

A worker's tensor plus its carried error is sent as one int8 sign an
element and one f32 scale, the mean of its magnitudes; what that loses is
carried to the next call. The signs go as int8, as in the JAX package
(8x less than f32, not 32x: neither wire has a 1-bit type). Counts under
`compressed_allreduce` in `comm.comm_stats()` the bytes of the signs and
scales it hands to the all-gathers: the JAX package's, the signs plus 4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch import comm


def compress_signs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 signs, +1 where x >= 0, else -1; the f32 scale mean(|x|)).
    The mean sums in f64, so a card and the host, which add in different
    orders, round it to the same f32."""
    scale = (x.abs().sum(dtype=torch.float64) / x.numel()).float()
    signs = torch.where(x >= 0, 1, -1).to(torch.int8)
    return signs, scale


def compressed_allreduce(x: torch.Tensor, error: torch.Tensor,
                         group: Optional[str] = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """The workers' mean of x + error, each sent as signs times its scale:
    returns (that mean, this worker's new error, x + error less what it
    sent)."""
    (avg,), (new_error,) = compressed_allreduce_many([x], [error], group)
    return avg, new_error


def compressed_allreduce_many(xs, errors, group: Optional[str] = "data"):
    """`compressed_allreduce` of each tensor with its error, one scale a
    tensor, the signs of all of them in one all-gather and their scales in
    another: ([the means], [the new errors]). Counts the bytes of one call
    a tensor."""
    corrected = [x + e for x, e in zip(xs, errors)]
    pairs = [compress_signs(c) for c in corrected]
    new_errors = [c - s.float() * sc for c, (s, sc) in zip(corrected, pairs)]
    signs = torch.cat([s.reshape(-1) for s, _ in pairs])
    scales = torch.stack([sc for _, sc in pairs])
    n = comm.get_world_size(group)
    sg = signs.new_empty((n, signs.numel()))
    sc = scales.new_empty((n, scales.numel()))
    with comm.wire("compressed_allreduce", group):
        comm.all_gather_into(sg, signs, group)
        comm.all_gather_into(sc, scales, group)
    sizes = [x.numel() for x in xs]
    means = []
    for i, (part, x) in enumerate(zip(sg.split(sizes, dim=1), xs)):
        means.append((part.float() * sc[:, i:i + 1]).mean(0).view_as(x))
    return means, new_errors
