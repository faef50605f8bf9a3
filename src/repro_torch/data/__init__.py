from repro_torch.data.pipeline import DataConfig, Prefetcher, latent_batch, token_batch

__all__ = ["DataConfig", "Prefetcher", "latent_batch", "token_batch"]
