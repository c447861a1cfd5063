from distdiff_tpu_torch.models.guide.factory import GuideModel, create_model

__all__ = ["GuideModel", "create_model"]
