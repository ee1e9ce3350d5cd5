"""utils/keys.py's KeyCache, the one rule for a key's device state kept by
the prover and the verifiers: a key's state is built once and handed back
as the same object, and a key past MAX_KEYS clears the others before it
is built."""

from wasmsnark_tpu_torch.utils.keys import MAX_KEYS, KeyCache


def _counting_build(built: list, key):
    def build():
        built.append(key)
        return object()
    return build


def test_same_key_same_object_built_once():
    cache, built = KeyCache(), []
    first = cache.get("a", _counting_build(built, "a"))
    assert cache.get("a", _counting_build(built, "a")) is first
    other = cache.get("b", _counting_build(built, "b"))
    assert other is not first
    assert cache.get("a", _counting_build(built, "a")) is first
    assert built == ["a", "b"] and len(cache) == 2


def test_key_past_the_bound_clears_the_others_first():
    cache, built = KeyCache(), []
    kept = [cache.get(k, _counting_build(built, k)) for k in range(MAX_KEYS)]
    assert MAX_KEYS == 4 and list(cache.values()) == kept

    def build():
        assert len(cache) == 0          # cleared before the build
        return "new"

    assert cache.get(MAX_KEYS, build) == "new"
    assert list(cache.values()) == ["new"]
    # an evicted key is built again
    cache.get(0, _counting_build(built, 0))
    assert built == list(range(MAX_KEYS)) + [0] and len(cache) == 2


def test_pop_and_clear():
    cache, built = KeyCache(), []
    cache.get("a", _counting_build(built, "a"))
    cache.get("b", _counting_build(built, "b"))
    cache.pop("a")
    cache.pop("missing")
    assert len(cache) == 1
    cache.get("a", _counting_build(built, "a"))
    assert built == ["a", "b", "a"]
    cache.clear()
    assert len(cache) == 0 and list(cache.values()) == []
