from repro_torch.serving.engine import ServeEngine, sample_greedy

__all__ = ["ServeEngine", "sample_greedy"]
