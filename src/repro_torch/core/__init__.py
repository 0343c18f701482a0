"""Capture to Chakra: the port's counterpart of ``src/repro/core``'s
capture, converter and graph (the cost model, passes and search stay the
JAX package's)."""
from repro_torch.core.capture import (CaptureResult, capture_sharded_step,  # noqa: F401
                                      capture_step, fake_mode)
from repro_torch.core.convert import fx_to_chakra  # noqa: F401
