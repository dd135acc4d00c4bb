"""Path helpers (reference ``stoch_gpmp/utils.py:7-15``)."""

from __future__ import annotations

from pathlib import Path


def get_root_path() -> Path:
    """Repository root (two levels above this package)."""
    return Path(__file__).resolve().parent.parent.parent


def get_assets_path() -> Path:
    """Optional on-disk assets directory (URDFs etc.). The Panda model is
    embedded in code (``kinematics/panda_model.py``), so assets are only
    needed for user-provided robots."""
    return get_root_path() / "assets"
