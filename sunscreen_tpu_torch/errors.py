"""Typed error hierarchy (reference: per-crate error enums —
`sunscreen/src/error.rs`, `sunscreen_runtime/src/error.rs`,
`seal_fhe` Error). Library paths raise these instead of bare
AssertionError so callers can catch by category.
"""


class SunscreenError(Exception):
    """Base for all framework errors."""


class InvalidArgument(SunscreenError):
    """A user-supplied value has the wrong shape/type/range
    (reference: `sunscreen_runtime::Error::ArgumentMismatch`)."""


class ParamsError(SunscreenError):
    """An invalid BFV/TFHE parameter set (reference: seal_fhe
    `EncryptionParameterError` / params validation)."""


class Unsupported(SunscreenError):
    """A requested feature combination is not supported (reference:
    `sunscreen::Error::Unsupported`, `sunscreen/src/error.rs`)."""
