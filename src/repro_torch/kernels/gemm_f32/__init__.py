from repro_torch.kernels.gemm_f32.ops import matmul_f32
from repro_torch.kernels.gemm_f32.ref import gemm_f32_ref, split_tf32, tf32_rna

__all__ = ["gemm_f32_ref", "matmul_f32", "split_tf32", "tf32_rna"]
