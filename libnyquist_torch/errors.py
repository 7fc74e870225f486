"""Exception hierarchy of the port (the same surface as the reference
package's errors module: reference include/libnyquist/Decoders.h:69-71
declares UnsupportedExtensionEx, LoadPathNotImplEx, LoadBufferNotImplEx)."""

from __future__ import annotations


class NyquistError(Exception):
    """Base class for all libnyquist_torch errors."""


class UnsupportedExtensionError(NyquistError):
    """No decoder is registered for the requested extension / magic bytes."""


class LoadPathNotImplementedError(NyquistError):
    """The decoder cannot load from a filesystem path."""


class LoadBufferNotImplementedError(NyquistError):
    """The decoder cannot load from an in-memory buffer."""


class DecodeError(NyquistError):
    """Malformed or unsupported bitstream content."""


class TruncatedDataError(DecodeError):
    """Stream ended before the declared payload was complete."""
