"""repro_torch.launch — command-line entry points (the serving and training launchers)."""
