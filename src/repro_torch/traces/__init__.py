"""repro_torch.traces — arrival, price, PUE, bandwidth and dataset traces."""
