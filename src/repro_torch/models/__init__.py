from repro_torch.models.registry import Model, get_model
