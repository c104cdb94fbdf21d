"""Parity oracles in numpy — the port's copies of `vitrs_tpu/oracle/`."""

from . import numpy_ref
