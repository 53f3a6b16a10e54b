from repro_torch.reuse.manager import MaterializationStore, ReuseManager, ReuseStats

__all__ = ["MaterializationStore", "ReuseManager", "ReuseStats"]
