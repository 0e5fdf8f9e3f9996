"""Device manager — port of ``spark_rapids_tpu/memory/device_manager.py``
(``DeviceManager``, ``hbm_budget_bytes``, ``memory_in_use``,
``hbm_watermarks``): the ``GpuDeviceManager`` analog.

One manager per distinct device and memory configuration (sessions that
set their own budgets or spill directory get their own catalog), holding
the spill catalog (:mod:`.spill`) and the task semaphore
(:mod:`.semaphore`):

* device budget: ``spark.rapids.memory.tpu.spillBudgetBytes`` when set,
  else the card's total memory (``torch.cuda.mem_get_info``) times
  ``spark.rapids.memory.tpu.allocFraction``, read at the first budget
  check; a CPU manager takes 16 GiB times the fraction;
* host tier: ``spark.rapids.memory.host.spillStorageSize``;
* disk tier: ``spark.rapids.memory.tpu.spillDir``;
* the IO lane: ``spark.rapids.tpu.spill.ioThreads``.
"""

from __future__ import annotations

import atexit
from typing import Dict

import torch

from ..config import (CONCURRENT_ACQUIRE_TIMEOUT, CONCURRENT_TPU_TASKS,
                      DEVICE_SPILL_BUDGET, HBM_ALLOC_FRACTION,
                      HOST_SPILL_STORAGE_SIZE, SPILL_DIR, SPILL_IO_THREADS,
                      TorchConf)
from ..utils import lockdep
from .semaphore import TpuSemaphore
from .spill import BufferCatalog

#: Memory a CPU manager budgets a fraction of (the reference's default
#: when the backend reports no size).
_DEFAULT_DEVICE_BYTES = 16 << 30


class DeviceManager:
    _instances: Dict[tuple, "DeviceManager"] = {}
    _lock = lockdep.lock("DeviceManager._lock")

    def __init__(self, conf: TorchConf, device: torch.device):
        self.device = torch.device(device)
        self._frac = float(conf.get(HBM_ALLOC_FRACTION))
        self.semaphore = TpuSemaphore(conf.get(CONCURRENT_TPU_TASKS),
                                      conf.get(CONCURRENT_ACQUIRE_TIMEOUT))
        self._hbm_budget = None
        self._peak_in_use = 0
        self._stats_lock = lockdep.lock("DeviceManager._stats_lock")
        explicit = int(conf.get(DEVICE_SPILL_BUDGET))
        self.catalog = BufferCatalog(
            explicit if explicit > 0 else (lambda: self.hbm_budget_bytes),
            conf.get(HOST_SPILL_STORAGE_SIZE), conf.get(SPILL_DIR),
            io_threads=conf.get(SPILL_IO_THREADS), device=self.device)

    def total_memory(self) -> int:
        """The card's memory in bytes (16 GiB for a CPU manager)."""
        if self.device.type == "cuda":
            return int(torch.cuda.mem_get_info(self.device)[1])
        return _DEFAULT_DEVICE_BYTES

    @property
    def hbm_budget_bytes(self) -> int:
        """The device store's budget: allocFraction of the card."""
        if self._hbm_budget is None:
            self._hbm_budget = int(self.total_memory() * self._frac)
        return self._hbm_budget

    @classmethod
    def get_or_create(cls, conf: TorchConf, device) -> "DeviceManager":
        device = torch.device(device)
        key = (str(device), conf.get(HBM_ALLOC_FRACTION),
               conf.get(DEVICE_SPILL_BUDGET),
               conf.get(HOST_SPILL_STORAGE_SIZE), conf.get(SPILL_DIR),
               conf.get(SPILL_IO_THREADS), conf.get(CONCURRENT_TPU_TASKS),
               conf.get(CONCURRENT_ACQUIRE_TIMEOUT))
        with cls._lock:
            inst = cls._instances.get(key)
            if inst is None:
                inst = cls._instances[key] = DeviceManager(conf, device)
            return inst

    @classmethod
    def reset(cls) -> None:
        """Close every manager's catalog and forget the managers."""
        with cls._lock:
            insts = list(cls._instances.values())
            cls._instances.clear()
        for inst in insts:
            inst.catalog.close()

    def _allocator_bytes(self):
        """(bytes the caching allocator has handed out now, its peak since
        the process started or the last ``reset_peak_memory_stats``), from
        one read of its statistics; (0, 0) off the card."""
        if self.device.type != "cuda":
            return 0, 0
        stats = torch.cuda.memory_stats(self.device)
        return (int(stats.get("allocated_bytes.all.current", 0)),
                int(stats.get("allocated_bytes.all.peak", 0)))

    def memory_in_use(self) -> int:
        """Bytes the caching allocator has handed out on the card now."""
        used, peak = self._allocator_bytes()
        with self._stats_lock:
            self._peak_in_use = max(self._peak_in_use, used, peak)
        return used

    def hbm_watermarks(self) -> dict:
        """``{"hbmBytesInUse", "hbmPeakBytesInUse"}`` for the profile: the
        allocator's bytes now and the highest peak seen."""
        used = self.memory_in_use()
        with self._stats_lock:
            return {"hbmBytesInUse": used,
                    "hbmPeakBytesInUse": self._peak_in_use}


# the catalogs' spill files and their temporary directories go with the
# process
atexit.register(DeviceManager.reset)
