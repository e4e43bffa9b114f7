from keystone_tpu_torch.workflow.pipeline import (
    Estimator,
    Gather,
    LabelEstimator,
    Pipeline,
    Transformer,
)

__all__ = ["Estimator", "Gather", "LabelEstimator", "Pipeline", "Transformer"]
