"""Models of the port (``tpudml.models`` subset: the transformer LM and
the ResNets)."""

from tpudml_torch.models.resnet import (
    BasicBlock, BottleneckBlock, ResNet, ResNet18, ResNet34, ResNet50,
)
from tpudml_torch.models.transformer import TransformerBlock, TransformerLM

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "TransformerBlock", "TransformerLM"]
