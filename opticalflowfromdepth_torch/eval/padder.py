"""InputPadder: pad-to-divisible for native-resolution eval (E1/E2).

Reference `adjusted_RAFT/core/utils/utils.py:7-24` /
`adjusted_gmflow/utils/utils.py` (same class with configurable
padding_factor). Replicate-edge padding; 'sintel' centers the pad, other
modes pad bottom/right-top style ([0, pad_ht] on height).

Host-side numpy on NHWC arrays; the port's own copy of
``opticalflowfromdepth_tpu/eval/padder.py``.
"""

from __future__ import annotations

from typing import List

import numpy as np


class InputPadder:
    def __init__(self, dims, mode: str = "sintel", padding_factor: int = 8):
        self.ht, self.wd = dims[-3:-1] if len(dims) >= 3 else dims
        f = padding_factor
        pad_ht = (((self.ht // f) + 1) * f - self.ht) % f
        pad_wd = (((self.wd // f) + 1) * f - self.wd) % f
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:  # 'kitti': top pad only (`utils.py:15-16`)
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs: np.ndarray) -> List[np.ndarray]:
        """Pad NHWC (or HWC) arrays with edge replication."""
        l, r, t, b = self._pad
        out = []
        for x in inputs:
            widths = [(0, 0)] * (x.ndim - 3) + [(t, b), (l, r), (0, 0)]
            out.append(np.pad(x, widths, mode="edge"))
        return out

    def unpad(self, x: np.ndarray) -> np.ndarray:
        l, r, t, b = self._pad
        ht, wd = x.shape[-3:-1]
        return x[..., t:ht - b, l:wd - r, :]
