from repro_torch.serve.decode import greedy_generate, init_caches

__all__ = ["greedy_generate", "init_caches"]
