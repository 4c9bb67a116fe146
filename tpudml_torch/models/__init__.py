"""Models of the port (``tpudml.models``: the transformer LM, its block, embedding and head
(the pipeline's stage, prologue and epilogue), the ResNets,
LeNet, its two-stage split and the MLP)."""

from tpudml_torch.models.lenet import LeNet
from tpudml_torch.models.mlp import ForwardMLP
from tpudml_torch.models.resnet import (
    BasicBlock, BottleneckBlock, ResNet, ResNet18, ResNet34, ResNet50,
)
from tpudml_torch.models.staged import StagedModel, lenet_stages
from tpudml_torch.models.transformer import (
    TransformerBlock, TransformerEmbed, TransformerHead, TransformerLM,
)

__all__ = ["BasicBlock", "BottleneckBlock", "ForwardMLP", "LeNet", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "StagedModel", "TransformerBlock", "TransformerEmbed", "TransformerHead",
           "TransformerLM", "lenet_stages"]
