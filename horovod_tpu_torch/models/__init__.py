"""Models of the port, the counterparts of horovod_tpu/models: the
benchmark vision models (ResNet v1.5, VGG-16, Inception V3, the MNIST
MLP) and the flagship transformer."""

from . import transformer
from .inception import InceptionV3
from .mlp import MnistMLP
from .resnet import ResNet, ResNet50, ResNet101
from .transformer import TransformerConfig, TransformerLM
from .vgg import VGG, VGG16

__all__ = ["InceptionV3", "MnistMLP", "ResNet", "ResNet101", "ResNet50",
           "TransformerConfig", "TransformerLM", "VGG", "VGG16",
           "transformer"]
