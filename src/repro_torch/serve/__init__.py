"""repro_torch.serve — single-device model execution for serving."""
