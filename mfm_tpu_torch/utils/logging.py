"""Metric logging (counterpart of ``mfm_tpu.utils.logging``, without its
``log_figures``, which waits with ``--plots``).

JSONL on disk and a compact line on the log: ``log`` takes the per-chunk
training metrics, ``summary`` the final metric row, ``log_per_iteration``
one record per training iteration (``--full-metrics``). Weights & Biases
engages only when asked for and importable; without it a warning is logged
and the JSONL stays. Records are the reference's, field for field.
"""

import json
import logging
import os
import time
from typing import Optional

logger = logging.getLogger("mfm_tpu_torch")


def _is_secondary_process() -> bool:
    """True in a process other than rank 0 of an initialised
    ``torch.distributed`` group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_rank() != 0


class MetricLogger:
    """JSONL + log-line metric logger.

    log(dict)        per-chunk training metrics
    summary(dict)    final metric row
    """

    def __init__(
        self,
        run_dir: Optional[str] = None,
        run_name: str = "run",
        stdout_every: int = 1,
        use_wandb: bool = False,
        wandb_kwargs: Optional[dict] = None,
        primary_only: Optional[bool] = None,
    ):
        """``primary_only`` (default: whether ``torch.distributed`` is
        initialised with more than one process) makes every process but
        rank 0 a no-op, so that replicated metrics are written once. Pass
        False to log in every process."""
        if primary_only is None:
            import torch.distributed as dist

            primary_only = (dist.is_available() and dist.is_initialized()
                            and dist.get_world_size() > 1)
        self.enabled = not (primary_only and _is_secondary_process())
        self.run_dir = run_dir
        self.run_name = run_name
        self.stdout_every = stdout_every
        self._n = 0
        self._fh = None
        self._wandb = None
        self._t0 = time.time()
        if not self.enabled:
            return
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(os.path.join(run_dir, f"{run_name}.jsonl"), "a")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except ImportError:
                logger.warning("wandb requested but not installed; using JSONL only")

    def _write(self, rec: dict):
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def log(self, metrics: dict):
        if not self.enabled:
            return
        self._n += 1
        self._write({"_t": time.time() - self._t0, **metrics})
        if self._wandb is not None:
            self._wandb.log(metrics)
        if self.stdout_every and self._n % self.stdout_every == 0:
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            )
            logger.info("[%s] %s", self.run_name, parts)

    def summary(self, metrics: dict):
        if not self.enabled:
            return
        self._write({"_summary": True, **metrics})
        if self._wandb is not None:
            for k, v in metrics.items():
                self._wandb.run.summary[k] = v
        logger.info("[%s] summary: %s", self.run_name, metrics)

    def log_per_iteration(self, stacked: dict):
        """One record per training iteration from the run's per-iteration
        metric tensors (``MFMRun.metrics``), each {"iter": i, name: value}."""
        if not self.enabled or not stacked:
            return
        import numpy as np

        arrays = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
                  for k, v in stacked.items()}
        n = len(next(iter(arrays.values())))
        for i in range(n):
            rec = {"iter": i + 1}
            rec.update({k: float(v[i]) for k, v in arrays.items()})
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
            if self._wandb is not None:
                self._wandb.log(rec, step=i + 1)
        if self._fh is not None:
            self._fh.flush()
        logger.info(
            "[%s] wrote %d per-iteration records (%s)", self.run_name, n, ", ".join(arrays)
        )

    def finish(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._wandb is not None:
            self._wandb.finish()
