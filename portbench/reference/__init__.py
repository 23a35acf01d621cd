"""The plain references: PyTorch only, fp32, TF32 off."""
