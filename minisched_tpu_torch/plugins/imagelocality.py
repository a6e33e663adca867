"""ImageLocality score: prefer nodes that already hold the pod's images
(upstream imagelocality, wrapped by the reference's registry)."""
from __future__ import annotations

import torch

from .base import BatchedPlugin


class ImageLocality(BatchedPlugin):
    name = "ImageLocality"
    column_local = True  # reduces over image slots only, per node column

    def score(self, pf, nf, ctx) -> torch.Tensor:
        P, N = pf.images.shape[0], nf.images.shape[0]
        count = torch.zeros((P, N), dtype=torch.int32,
                            device=nf.images.device)
        for i in range(pf.images.shape[1]):
            want = pf.images[:, i, None]                     # (P,1)
            present = torch.zeros((P, N), dtype=torch.bool,
                                  device=nf.images.device)
            for j in range(nf.images.shape[1]):
                present |= want == nf.images[None, :, j]
            count += ((want != 0) & present).to(torch.int32)
        n_images = torch.clamp_min((pf.images != 0).sum(dim=1), 1)
        return 100.0 * count / n_images[:, None]
