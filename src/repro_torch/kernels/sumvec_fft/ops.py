"""Four-step-FFT sumvec over the ``cmatmul`` / ``ctwiddle`` kernels.

Port of ``repro/kernels/sumvec_fft/ops.py``.  Autograd runs through the
kernels' own vjps (``kernel.py``); the conjugate bases and twiddles those
need are cached constants handed in beside the forward ones.  Layout, with
t = t1*d2 + t2 and f = k1 + d1*k2:

  x (n, d) -> (n, d1, d2)                                  [t1, t2]
  step 1: contract t1 with W_{d1}  -> (n, d2, d1)          [t2, k1]
  step 2: twiddle W_d^{t2 k1}      -> (n, d2, d1)          [t2, k1]
  step 3: contract t2 with W_{d2}  -> (n, d1, d2)          [k1, k2]

The frequency accumulator G = sum_k conj(F1_k) o F2_k stays in the [k1, k2]
layout; for q = 2 the regularizer needs only full-spectrum sums (Parseval),
which are layout-invariant, so nothing is unscrambled.  For q = 1 (and for
padded plans) an inverse four-step yields the time-domain summary vector.

Plans (``fft_plan``) come from ``repro_torch.tune``: without an override or
a tuned cache entry, the reference's analytic pick — exact balanced factors
where they exist, else a padded length dp >= 2d - 1 whose linear
correlation folds back exactly onto the d circular lags
(``_fold_linear_to_circular``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.sumvec_fft import kernel as K
from repro_torch.kernels.utils import full_dft_adjoint, full_dft_matrices, pad_axis, tensor_cache
from repro_torch.tune.dispatch import best_config
from repro_torch.tune.space import balanced_factors

Tensor = torch.Tensor


def choose_factors(d: int) -> Tuple[int, int]:
    """d = d1 * d2 with d1 <= d2, d1 as close to sqrt(d) as possible.

    Exact (never pads): callers that need a factorization of d itself (the
    spectrum-layout tests) use this.  The regularizer entry points use
    :func:`fft_plan`, which may pick a padded length instead where the best
    exact factorization is pessimal (prime / near-prime d).
    """
    return balanced_factors(d)


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    """A four-step execution plan for logical DFT length d.

    dp == d: exact in-place factorization d = d1 * d2.
    dp > d : zero-pad to dp = d1 * d2 >= 2d - 1 and fold the linear
             correlation back to d circular lags (exact; see module doc).
    """

    d: int
    dp: int
    d1: int
    d2: int

    @property
    def padded(self) -> bool:
        return self.dp > self.d

    def __post_init__(self):
        # explicit raises, not asserts: a violated invariant means a silently
        # WRONG loss (aliased fold), which must not survive python -O
        if self.d1 * self.d2 != self.dp:
            raise ValueError(f"FFTPlan: d1 * d2 != dp ({self.d1} * {self.d2} != {self.dp})")
        if self.dp != self.d and self.dp < 2 * self.d - 1:
            raise ValueError(
                f"FFTPlan: padded dp={self.dp} < 2d-1={2 * self.d - 1} aliases the fold"
            )


def fft_plan(d: int) -> FFTPlan:
    """The tuned plan for length d: ``best_config("sumvec_fft_plan", (d,))``
    (override > memo > disk cache > the reference's analytic pick), asked
    at every call so an override or a newly tuned entry reaches the next
    one."""
    cfg = best_config("sumvec_fft_plan", (d,))
    return FFTPlan(d=d, dp=cfg["dp"], d1=cfg["d1"], d2=cfg["d2"])


@tensor_cache(maxsize=64)
def _twiddle(d1: int, d2: int, sign: int, device=None) -> Tuple[Tensor, Tensor]:
    """W_d^{sign * t2 * k1} flattened to (d2 * d1,) in [t2, k1] order
    (a read-only constant shared by every caller)."""
    d = d1 * d2
    t2 = np.arange(d2)[:, None]
    k1 = np.arange(d1)[None, :]
    ang = 2.0 * np.pi * t2 * k1 / d * sign
    as_t = lambda a: torch.as_tensor(a.reshape(-1).astype(np.float32), device=device)
    return as_t(np.cos(ang)), as_t(np.sin(ang))


@tensor_cache(maxsize=64)
def _twiddle_conj(d1: int, d2: int, sign: int, device=None) -> Tuple[Tensor, Tensor]:
    """conj of ``_twiddle(d1, d2, sign, device)``: the ctwiddle vjp's plane."""
    wr, wi = _twiddle(d1, d2, sign, device)
    return wr, -wi


def four_step_fft(x: Tensor, d1: int, d2: int) -> Tuple[Tensor, Tensor]:
    """Full complex DFT of real rows x (n, d). Returns (n, d1, d2) pair in
    [k1, k2] layout (f = k1 + d1*k2)."""
    n, d = x.shape
    if d != d1 * d2:
        raise ValueError(f"four_step_fft: d={d} != d1 * d2 = {d1} * {d2}")
    dev = x.device
    w1r, w1i = full_dft_matrices(d1, -1, dev)
    w2r, w2i = full_dft_matrices(d2, -1, dev)
    twr, twi = _twiddle(d1, d2, -1, dev)
    adj1 = full_dft_adjoint(d1, -1, dev)
    adj2 = full_dft_adjoint(d2, -1, dev)
    tw_conj = _twiddle_conj(d1, d2, -1, dev)

    xt = x.float().reshape(n, d1, d2).transpose(1, 2).reshape(n * d2, d1)  # [t2, t1]
    s1r, s1i = K.rmatmul_complex_basis(xt, w1r, w1i, adj1)  # [t2, k1]
    s2r, s2i = K.ctwiddle(s1r.reshape(n, d2 * d1), s1i.reshape(n, d2 * d1), twr, twi, tw_conj)
    s2r = s2r.reshape(n, d2, d1).transpose(1, 2).reshape(n * d1, d2)  # [k1, t2]
    s2i = s2i.reshape(n, d2, d1).transpose(1, 2).reshape(n * d1, d2)
    s3r, s3i = K.cmatmul(s2r, s2i, w2r, w2i, adj2)  # contract t2 -> [k1, k2]
    return s3r.reshape(n, d1, d2), s3i.reshape(n, d1, d2)


def four_step_ifft(gr: Tensor, gi: Tensor, d1: int, d2: int) -> Tensor:
    """Inverse DFT of (..., d1, d2) [k1, k2]-layout spectrum; returns the
    real part in natural time order (..., d) (imag is ~0 for our G)."""
    lead = gr.shape[:-2]
    n = int(np.prod(lead)) if lead else 1
    d = d1 * d2
    dev = gr.device
    w1r, w1i = full_dft_matrices(d1, 1, dev)
    w2r, w2i = full_dft_matrices(d2, 1, dev)
    twr, twi = _twiddle(d1, d2, 1, dev)
    adj1 = full_dft_adjoint(d1, 1, dev)
    adj2 = full_dft_adjoint(d2, 1, dev)
    tw_conj = _twiddle_conj(d1, d2, 1, dev)

    g2r = gr.reshape(n * d1, d2).contiguous()
    g2i = gi.reshape(n * d1, d2).contiguous()
    s1r, s1i = K.cmatmul(g2r, g2i, w2r, w2i, adj2)  # contract k2 -> [k1, t2]
    s1r = s1r.reshape(n, d1, d2).transpose(1, 2).reshape(n, d2 * d1)  # [t2, k1]
    s1i = s1i.reshape(n, d1, d2).transpose(1, 2).reshape(n, d2 * d1)
    s2r, s2i = K.ctwiddle(s1r, s1i, twr, twi, tw_conj)
    s2r = s2r.reshape(n * d2, d1)
    s2i = s2i.reshape(n * d2, d1)
    s3r, _ = K.cmatmul(s2r, s2i, w1r, w1i, adj1)  # contract k1 -> [t2, t1]
    return s3r.reshape(n, d2, d1).transpose(1, 2).reshape(*lead, d) / d


def frequency_accumulator_fourstep(
    z1: Tensor, z2: Tensor, d1: int, d2: int
) -> Tuple[Tensor, Tensor]:
    """G = sum_k conj(F z1_k) o (F z2_k), (d1, d2) [k1,k2] layout pair.

    ``z2 is z1`` (the self-correlation probe) transforms the rows once.
    """
    f1r, f1i = four_step_fft(z1, d1, d2)
    f2r, f2i = (f1r, f1i) if z2 is z1 else four_step_fft(z2, d1, d2)
    gr = torch.sum(f1r * f2r + f1i * f2i, dim=0)
    gi = torch.sum(f1r * f2i - f1i * f2r, dim=0)
    return gr, gi


def _fold_linear_to_circular(sv: Tensor, d: int) -> Tensor:
    """Exact length-d circular summary vector from a length-dp (dp >= 2d-1)
    linear-correlation output: sv_d[t] = lin[t] + lin[-(d-t)], where lag -s
    sits at index dp - s of the padded circular output."""
    dp = sv.shape[-1]
    if dp == d:
        return sv
    head = sv[..., :d]
    neg = sv[..., dp - d + 1 :]  # lags -(d-1) .. -1
    zero = torch.zeros(sv.shape[:-1] + (1,), dtype=sv.dtype, device=sv.device)
    return head + torch.cat([zero, neg], dim=-1)


def _padded_views(z1: Tensor, z2: Tensor, dp: int) -> Tuple[Tensor, Tensor]:
    """Both views as contiguous f32 rows zero-padded to dp features; the
    identity ``z2 is z1`` survives, so a self-correlation transforms once."""
    a = pad_axis(z1.float(), 1, dp).contiguous()
    return a, (a if z2 is z1 else pad_axis(z2.float(), 1, dp).contiguous())


def _sumvec_impl(z1: Tensor, z2: Tensor, s: float, plan: FFTPlan) -> Tensor:
    """Length-d time-domain summary vector through the (possibly padded)
    four-step pipeline."""
    gr, gi = frequency_accumulator_fourstep(*_padded_views(z1, z2, plan.dp), plan.d1, plan.d2)
    sv = four_step_ifft(gr, gi, plan.d1, plan.d2).reshape(plan.dp)
    return _fold_linear_to_circular(sv, plan.d) / s


def _resolve_plan(d: int, plan: Optional[FFTPlan]) -> FFTPlan:
    plan = fft_plan(d) if plan is None else plan
    if plan.d != d:
        # raise, don't assert: a stale plan under python -O would fold to
        # plan.d and return a silently wrong loss
        raise ValueError(f"plan built for d={plan.d}, inputs have d={d}")
    return plan


def r_sum_fourstep(
    z1: Tensor,
    z2: Tensor,
    *,
    q: int = 2,
    scale: Optional[float] = None,
    plan: Optional[FFTPlan] = None,
) -> Tensor:
    """Ungrouped Eq. (6) through the four-step kernel pipeline.

    ``plan=None`` takes :func:`fft_plan`; pass an explicit :class:`FFTPlan`
    to pin the factorization.
    """
    plan = _resolve_plan(z1.shape[-1], plan)
    s = 1.0 if scale is None else float(scale)
    if q == 2 and not plan.padded:
        # Full-spectrum Parseval: sum_t sv[t]^2 = (1/d) sum_f |G_f|^2,
        # sv[0] = (1/d) sum_f Re G_f — layout invariant, no inverse FFT.
        gr, gi = frequency_accumulator_fourstep(*_padded_views(z1, z2, plan.d), plan.d1, plan.d2)
        gr, gi = gr / s, gi / s
        sq = torch.sum(gr**2 + gi**2) / plan.d
        s0 = torch.sum(gr) / plan.d
        return sq - s0**2
    # padded plans fold in the time domain (Parseval at dp would regroup the
    # wrapped diagonals); q = 1 needs the time domain regardless.
    sv = _sumvec_impl(z1, z2, s, plan)
    if q == 2:
        return torch.sum(sv**2) - sv[0] ** 2
    return torch.sum(torch.abs(sv[1:]))


def sumvec_fourstep(
    z1: Tensor,
    z2: Tensor,
    scale: Optional[float] = None,
    plan: Optional[FFTPlan] = None,
) -> Tensor:
    """Time-domain sumvec via four-step fwd+inv (kernel analogue of Eq. 12)."""
    plan = _resolve_plan(z1.shape[-1], plan)
    s = 1.0 if scale is None else float(scale)
    return _sumvec_impl(z1, z2, s, plan)
