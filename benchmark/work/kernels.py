"""Operations and bytes the port's kernels need, from shapes alone.

Copied from the port's `chip_smoke.py` (`stack_work`) and
frozen here, with the stack's weight count worked out from the shapes
rather than read from the packed arrays.  Each input byte is counted read
once and each output byte written once.
"""
from __future__ import annotations


def stack_work(n_repeats: int, dim: int, filters: int, halves, batch: int,
               has_mix: bool = False) -> dict:
    """One direction of the RealNVP / Glow fused stack over `batch` rows:
    the conditioner's multiply-adds (2 flops each) and elementwise
    operations at width F, the Glow mix's D*D multiply-adds, the inputs,
    outputs and packed weights moved once.  `halves[parity]` is (len(z0),
    len(z1)) of the couplings of that parity."""
    D, F = dim, filters
    mac = elem = weights = 0
    for c in range(n_repeats):
        out, inp = halves[c % 2]
        mix = D * D if has_mix else 0
        mac += 2 * (inp * F + 4 * F * F + 2 * out * F + mix)
        # norm 2D; biases 5F + 2out; BN affine + ReLU 15F; residual 2F;
        # coupling tanh, gain, bias, exp, mul, add, logdet sum 7out
        elem += 2 * D + 22 * F + 9 * out
        # pre (D, 2) | mix (D, D) | W0 (F, in) | VEC (F, 15) | WR (4, F, F)
        # | Wh (2out, F) | bh (2out) | gb (2)
        weights += 2 * D + mix + F * inp + 15 * F + 4 * F * F + 2 * out * F + 2 * out + 2
    return {"flop": batch * (mac + elem), "mac_flop": batch * mac, "elem": batch * elem,
            "transcendental": 0, "bytes": 4 * (2 * batch * D + batch + weights)}


def bound_s(work: dict, mac_flops_per_s: float, flops_per_s: float,
            bytes_per_s: float) -> float:
    """The least time the card could take: the largest of the multiply-adds
    at `mac_flops_per_s`, the other f32 operations at `flops_per_s` and
    the bytes at `bytes_per_s`."""
    return max(work["mac_flop"] / mac_flops_per_s,
               (work["flop"] - work["mac_flop"]) / flops_per_s,
               work["bytes"] / bytes_per_s)
