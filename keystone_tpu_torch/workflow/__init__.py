from keystone_tpu_torch.workflow.graph import Graph, GraphId, NodeId, SourceId
from keystone_tpu_torch.workflow.pipeline import (
    Estimator,
    FusedTransformer,
    GatherTransformer,
    LabelEstimator,
    Pipeline,
    PipelineDataset,
    Transformer,
)
from keystone_tpu_torch.workflow.executor import GraphExecutor, PipelineEnv, on_device
from keystone_tpu_torch.workflow.functional import fitted_forward
from keystone_tpu_torch.workflow.optimizer import (
    ChainFusionRule,
    EquivalentNodeMergeRule,
    Optimizer,
    Rule,
    default_optimizer,
)

__all__ = [
    "Graph",
    "GraphId",
    "NodeId",
    "SourceId",
    "Transformer",
    "FusedTransformer",
    "GatherTransformer",
    "Estimator",
    "LabelEstimator",
    "Pipeline",
    "PipelineDataset",
    "PipelineEnv",
    "GraphExecutor",
    "on_device",
    "fitted_forward",
    "Optimizer",
    "Rule",
    "ChainFusionRule",
    "EquivalentNodeMergeRule",
    "default_optimizer",
]
