"""SigLIP towers in PyTorch, numerically held to the JAX package's models."""

from distributed_sigmoid_loss_tpu_torch.models.convert import params_from_jax
from distributed_sigmoid_loss_tpu_torch.models.hf_import import config_from_hf, params_from_hf
from distributed_sigmoid_loss_tpu_torch.models.moe import MoeMlp
from distributed_sigmoid_loss_tpu_torch.models.siglip import SigLIP
from distributed_sigmoid_loss_tpu_torch.models.text import TextTransformer
from distributed_sigmoid_loss_tpu_torch.models.towers import LinearTower, toy_tower_apply
from distributed_sigmoid_loss_tpu_torch.models.vit import PatchEmbed, ViT

__all__ = ["SigLIP", "ViT", "PatchEmbed", "TextTransformer", "params_from_jax",
           "config_from_hf", "params_from_hf", "LinearTower", "toy_tower_apply", "MoeMlp"]
