"""`pattern_matcher` shim (MultiClass-TASC-model/pattern_matcher.py)."""
from ..data.pattern_matcher import PatternMatcher

__all__ = ["PatternMatcher"]
