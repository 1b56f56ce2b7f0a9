"""GOOD fixture: the port's page pools, annotated."""
from typing import Optional, Tuple

import torch


def init_page_pools(n_layers: int, n_pages: int, dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros(n_layers, n_pages, dtype=dtype)
    return z, z.clone()


class Pool:
    def __init__(self, n: int) -> None:
        self.n = n

    def take(self, n: int, *,
             device: Optional[torch.device] = None) -> list:
        return [n, device]
