"""The paper's own hardware-conform models (§VI-A): MLP-GSC, MLP-HR,
LeNet-300-100.  Feature widths are exactly the paper's; these run through
models/mlp.py (BatchNorm-folded alpha1, ReLU, alpha2 epilogue — the
FantastIC4 §V pipeline) and are the subjects of the Table II / Fig 9 /
Fig 11 benchmark analogues.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str
    features: Tuple[int, ...]      # layer output widths
    d_in: int
    batch_norm: bool = True
    lam: float = 0.02

MLP_GSC = MLPConfig("mlp-gsc", (512, 512, 256, 256, 128, 128, 12), d_in=512)
MLP_HR = MLPConfig("mlp-hr", (512, 256, 128, 12), d_in=512)
LENET_300_100 = MLPConfig("lenet-300-100", (300, 100, 10), d_in=784,
                          batch_norm=False)

MLPS = {m.name: m for m in (MLP_GSC, MLP_HR, LENET_300_100)}
