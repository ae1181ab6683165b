"""The paper's own experimental model: a small 3-layer MLP classifier
(~100k params, §3.5 / Table 1).  Counterpart of
``repro.configs.paper_mlp``, kept as a copy: the port imports nothing of
the JAX package."""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MLPConfig:
    name: str = "paper-mlp"
    in_dim: int = 64
    hidden: Tuple[int, ...] = (256, 256)
    num_classes: int = 10

    @property
    def num_params(self) -> int:
        dims = (self.in_dim, *self.hidden, self.num_classes)
        return sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))


# Table 1 rows, exact parameter counts.
# 109386 = the classic MNIST MLP 784-128-64-10 (inc. biases).  101770 has
# no 784-input 3-layer factorization; 256-212-212-10 matches it exactly.
TABLE1_A = MLPConfig(name="table1-a", in_dim=784, hidden=(128, 64), num_classes=10)
TABLE1_B = MLPConfig(name="table1-b", in_dim=256, hidden=(212, 212), num_classes=10)
