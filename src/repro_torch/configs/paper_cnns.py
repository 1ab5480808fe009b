"""The paper's own benchmark models (Table II): ResNet-18/50, MobileNetV2/V3.

These power the paper-faithful benchmarks (Table II / Fig. 1 / 4 / 5 / 6
analogues). They are *additional* to the ten assigned LM architectures.
"""
from repro_torch.configs.base import ModelConfig


def _cnn(name: str, arch: str) -> ModelConfig:
    return ModelConfig(name=name, family="cnn", cnn_arch=arch,
                       img_res=224, num_classes=1000, dtype="bfloat16")


RESNET18 = _cnn("resnet18", "resnet18")
RESNET50 = _cnn("resnet50", "resnet50")
MOBILENETV2 = _cnn("mobilenetv2", "mobilenetv2")
MOBILENETV3S = _cnn("mobilenetv3s", "mobilenetv3s")
MOBILENETV3L = _cnn("mobilenetv3l", "mobilenetv3l")

PAPER_CNNS = (RESNET18, RESNET50, MOBILENETV2, MOBILENETV3S, MOBILENETV3L)
