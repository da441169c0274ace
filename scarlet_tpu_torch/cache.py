"""Process-global memo cache for expensive host-side precomputations
(monotonicity weights, Fourier shift phasors, ...).

Only host-side setup code uses it.  Behavioral reference:
scarlet/cache.py:1-29.
"""

__all__ = ["Cache"]


class Cache:
    _cache = {}

    @staticmethod
    def check(name, key):
        return Cache._cache[name][key]

    @staticmethod
    def set(name, key, content):
        Cache._cache.setdefault(name, {})[key] = content

    @staticmethod
    def clear():
        Cache._cache.clear()
