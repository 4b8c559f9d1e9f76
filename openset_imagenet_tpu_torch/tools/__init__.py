"""Bench tools of the PyTorch port, run on the card:
``python -m openset_imagenet_tpu_torch.tools.bench_split_site`` (the tail
site backward: plain, K5 and K6) and ``...tools.bench_stream`` (the
streaming probes, K7)."""
