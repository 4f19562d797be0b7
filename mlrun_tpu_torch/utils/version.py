"""The package's version."""

from __future__ import annotations


def get_version() -> str:
    from .. import __version__

    return __version__


class Version:
    """Version info provider."""

    @staticmethod
    def get() -> dict:
        return {"version": get_version()}
