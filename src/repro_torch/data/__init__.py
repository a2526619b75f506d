from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: F401
