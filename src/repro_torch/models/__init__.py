from repro_torch.models.model import Ctx, Model  # noqa: F401
