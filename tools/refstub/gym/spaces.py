"""Minimal gym.spaces stub.

Re-exports gym_soccer_tpu's space classes: the API subset matches what the
reference constructor uses (Discrete(n)/.n, Dict over a mapping, indexing,
membership), and sharing classes lets the reference's own isinstance
checks pass when its test suite runs against this framework via
tools/refcompat."""
from gym_soccer_tpu.spaces import Dict, Discrete, MultiDiscrete  # noqa: F401
