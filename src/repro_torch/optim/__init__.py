from repro_torch.optim.adamw import OptConfig, init_opt, apply_updates, lr_at

__all__ = ["OptConfig", "init_opt", "apply_updates", "lr_at"]
