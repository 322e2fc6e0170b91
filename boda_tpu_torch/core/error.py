"""Framework error type.

Capability parity with the reference's rt_exception/rt_err (boda_base.H:98):
a single structured error type raised by all framework layers, whose message
text is stable enough to be pinned by expected-error regression tests
(reference: test_nesi.cc:548-559 exact error-string matching).

The port's copy of boda_tpu/core/error.py.
"""

from __future__ import annotations


class RtErr(RuntimeError):
    """Framework runtime error with a stable, test-pinnable message."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.msg = msg

    def __str__(self) -> str:
        return self.msg


def rt_err(msg: str) -> "NoReturn":  # noqa: F821
    raise RtErr(msg)
