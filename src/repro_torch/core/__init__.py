"""Core math of the port: summary vectors, regularizers, permutation, the
LM decorrelation aux loss and the whitening baseline."""

from repro_torch.core.decorrelation import LMDecorrConfig, lm_decorrelation_loss, subsample_tokens
from repro_torch.core.whitening import newton_schulz_inv_sqrt, wmse_loss, zca_whiten
