"""Errors of the paged KV pool.

The paged slot manager (``polyaxon_tpu/serving/paged.py``: block-table
pages, copy-on-write shared prefixes, the host spill tier and its wire
format) comes with its own slice of the port.  Until then this module
holds the two error types other serving modules name.
"""

from __future__ import annotations

__all__ = ["PageExhausted", "WirePayloadError"]


class PageExhausted(RuntimeError):
    """Page reservation failed.  Engine admission is gated on
    ``can_admit`` so this is a defensive error, not a control path."""


class WirePayloadError(ValueError):
    """A serialized spill payload failed integrity verification
    (truncated body, checksum mismatch, malformed header).  Callers
    on the fetch path treat this as a typed MISS — fall back to
    re-prefill, never admit bytes that don't verify."""
