"""Exception hierarchy of the port (the same surface as the reference
package's errors module, trimmed to what the Opus slice raises)."""

from __future__ import annotations


class NyquistError(Exception):
    """Base class for all libnyquist_torch errors."""


class UnsupportedExtensionError(NyquistError):
    """No decoder is registered for the requested extension / magic bytes."""


class DecodeError(NyquistError):
    """Malformed or unsupported bitstream content."""
