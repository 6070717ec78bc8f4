"""Core math of the port: summary vectors, regularizers, losses,
permutation, the LM decorrelation aux loss and the whitening baseline.

Exports the 34 names of ``repro.core`` (every one has its twin here), plus
the whitening baseline."""

from repro_torch.core.sumvec import (
    involution,
    circular_convolve,
    circular_correlate_naive,
    sumvec_from_matrix,
    sumvec_fft,
    sumvec_direct,
    frequency_accumulator,
    grouped_frequency_accumulator,
    grouped_sumvec_fft,
    grouped_sumvec_from_matrix,
)
from repro_torch.core.regularizers import (
    r_off,
    r_var,
    r_var_from_embeddings,
    r_sum,
    r_sum_grouped,
    r_sum_auto,
    r_sum_from_sumvec,
    r_sum_from_matrix,
    r_sum_grouped_from_matrix,
    cross_correlation_matrix,
)
from repro_torch.core.losses import (
    DecorrConfig,
    barlow_twins_loss,
    vicreg_loss,
    ssl_loss,
    standardize,
    center,
    normalized_bt_regularizer,
    normalized_vic_regularizer,
)
from repro_torch.core.permutation import permute_views, permutation_for_step, permute_features
from repro_torch.core.decorrelation import LMDecorrConfig, lm_decorrelation_loss, subsample_tokens
from repro_torch.core.whitening import newton_schulz_inv_sqrt, wmse_loss, zca_whiten

__all__ = [k for k in dir() if not k.startswith("_")]
