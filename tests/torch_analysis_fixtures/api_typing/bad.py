"""BAD fixture: the port's page pools without annotations."""
import torch


def init_page_pools(n_layers: int, n_pages: int, dtype: torch.dtype):
    return torch.zeros(n_layers, n_pages, dtype=dtype)


class Pool:
    def take(self, n, *, device=None) -> list:
        return [n, device]
