"""Frozen copy of the port's memo cache (``cache.py``), verbatim."""


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
