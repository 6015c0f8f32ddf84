from repro_torch.models.model import Model

__all__ = ["Model"]
