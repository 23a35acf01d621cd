"""repro_torch.traces — arrival, price, PUE, bandwidth, dataset and stage traces, and the token stream (``tokens``)."""
