"""Run configuration: ``MFMConfig`` and ``preset``, shared with ``mfm_tpu``.

The dataclass is defined once, in ``mfm_tpu/config.py``, which needs only
``dataclasses`` and ``typing``. Its source is executed here, so the port and
the reference read the same fields and presets while this process never
imports the JAX package. The field names keep their meaning, except
``pallas_field``, which here means "use the fused CUDA field kernel".
"""

from pathlib import Path

_SOURCE = Path(__file__).resolve().parents[1] / "mfm_tpu" / "config.py"
exec(compile(_SOURCE.read_text(), str(_SOURCE), "exec"), globals())

__all__ = ["MFMConfig", "preset", "from_yaml"]  # noqa: F822 (defined by exec)
