"""repro_torch.configs — the paper's 4-DC scenario and the N = 256 fleet."""
