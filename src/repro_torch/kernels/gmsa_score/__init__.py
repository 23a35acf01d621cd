from repro_torch.kernels.gmsa_score.ops import gmsa_score
from repro_torch.kernels.gmsa_score.ref import gmsa_score_phases_ref, gmsa_score_ref

__all__ = ["gmsa_score", "gmsa_score_phases_ref", "gmsa_score_ref"]
