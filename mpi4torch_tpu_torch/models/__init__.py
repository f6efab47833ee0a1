"""Models: the flagship decoder-only transformer, the data-parallel MLP,
ResNet-18 (CIFAR) and the Vision Transformer, each a port of the JAX
package's module of the same name."""

from . import mlp, resnet, transformer, vit

__all__ = ["mlp", "resnet", "transformer", "vit"]
