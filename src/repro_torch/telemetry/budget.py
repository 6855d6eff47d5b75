"""Memory-budget simulator — the browser's failure modes, parameterised.

The port's own copy of ``repro/telemetry/budget.py``. The paper's fail
taxonomy (Table V) is made of memory and resource-limit failures; this
module prices each inference strategy's peak working set, analytically in
bytes, against a configurable budget, and raises ``BudgetExceeded`` with
the strategy's fail type when it does not fit. ``MemoryBudget.h100()``
is one H100's 80 GiB of device memory, the port engine's default.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # annotation-only
    from repro_torch.core.meshnet import MeshNetConfig

# Browser-era texture sizes map to working-set budgets; device presets:
V5E_HBM_BYTES = 16 * 1024**3  # the reference engine's default preset
H100_HBM_BYTES = 80 * 1024**3  # one H100's device memory
WEBGL_LIKE_BUDGETS = {
    # texture_size -> approx usable bytes (texture^2 * 4 bytes RGBA)
    8192: 8192**2 * 4,  # 256 MiB
    9159: 9159**2 * 4,
    13585: 13585**2 * 4,
    16384: 16384**2 * 4,  # 1 GiB
    32768: 32768**2 * 4,  # 4 GiB
}


class BudgetExceeded(Exception):
    def __init__(self, fail_type: str, need: int, have: int):
        super().__init__(f"{fail_type}: need {need} bytes, budget {have}")
        self.fail_type = fail_type
        self.need = need
        self.have = have


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """A per-run memory budget in bytes (the simulated device)."""

    bytes_limit: int
    name: str = "custom"

    @staticmethod
    def unlimited() -> "MemoryBudget":
        return MemoryBudget(bytes_limit=1 << 62, name="unlimited")

    @staticmethod
    def from_texture_size(tex: int) -> "MemoryBudget":
        return MemoryBudget(WEBGL_LIKE_BUDGETS[tex], name=f"texture_{tex}")

    @staticmethod
    def v5e() -> "MemoryBudget":
        return MemoryBudget(V5E_HBM_BYTES, name="v5e_hbm")

    @staticmethod
    def h100() -> "MemoryBudget":
        return MemoryBudget(H100_HBM_BYTES, name="h100_hbm")

    # --- pricing of each strategy's peak working set ------------------------

    def _check(self, need: int, fail_type: str) -> None:
        if need > self.bytes_limit:
            raise BudgetExceeded(fail_type, need, self.bytes_limit)

    def charge_inference(self, shape, model: MeshNetConfig, dtype_bytes: int = 4) -> int:
        """Naive full-volume inference: all layer activations live (what a
        graph executor without disposal would allocate) -> the failure mode
        the paper's layer-streaming avoids."""
        vox = math.prod(shape[:3])
        layers = len(model.dilations)
        need = vox * model.channels * dtype_bytes * (layers + 1)
        need += vox * model.num_classes * dtype_bytes
        self._check(need, "full_volume_oom")
        return need

    def charge_streaming(self, shape, model: MeshNetConfig, dtype_bytes: int = 4) -> int:
        """Layer-streamed full volume: two live activations + logits."""
        vox = math.prod(shape[:3])
        need = vox * model.channels * dtype_bytes * 2
        need += vox * model.num_classes * dtype_bytes
        self._check(need, "streaming_oom")
        return need

    def charge_subvolume(self, cube: int, overlap: int, model: MeshNetConfig, dtype_bytes: int = 4) -> int:
        """Failsafe mode: one padded cube streamed + full-volume logits
        accumulated on host (as Brainchop merges into a JS array)."""
        side = cube + 2 * overlap
        need = side**3 * model.channels * dtype_bytes * 2
        need += side**3 * model.num_classes * dtype_bytes
        self._check(need, "subvolume_oom")
        return need
