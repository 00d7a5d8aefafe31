"""PyTorch port, the metric taxonomy cannot rot: the mirror of
`tests/test_observability_docs.py` for the port. Every counter, gauge,
histogram, span and flight-event name the port emits
(`fabric_token_sdk_tpu_torch/`, `multichip_torch.py`) is documented,
either in `docs/OBSERVABILITY.md` (the reference's names, which the port
keeps) or in the port's own section, `docs/OBSERVABILITY_TORCH.md`; every
metric-shaped name of the port's section still exists in the port's
code. The names the port adds are pinned both ways: the mesh plane's
`stages.sharded_calls`, `stages.shards` and
`pairing.staged.sharded_calls`, the dispatch ledger's overlap count,
`kernel.launches.<name>`, the `*.device_error` flight events and the
`batch.membership.*` spans. The parsing helpers are the reference
test's."""

import os
import re

from test_observability_docs import _PATTERNS, _doc_flight_kinds, _doc_names

REPO = os.path.join(os.path.dirname(__file__), "..")
REF_DOC = os.path.join(REPO, "docs", "OBSERVABILITY.md")
PORT_DOC = os.path.join(REPO, "docs", "OBSERVABILITY_TORCH.md")
# a flight kind built from the plane that raised it (`orderer.py:_plane_failed`)
PLANE_FLIGHTS = {f"{plane}.{what}" for plane in ("verify", "sign")
                 for what in ("device_error", "host_fallback")}


def _read(path):
    with open(path) as fh:
        return fh.read()


def _port_sources():
    for root, _dirs, files in os.walk(os.path.join(REPO, "fabric_token_sdk_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "multichip_torch.py")


def _emitted():
    """{(kind, name)} the port emits (f-string names cut at '{'), and the
    port's source as one text."""
    out, corpus = set(), []
    for path in _port_sources():
        text = _read(path)
        corpus.append(text)
        for kind, pat in _PATTERNS:
            for name in pat.findall(text):
                out.add((kind, name.split("{")[0]))
    return out, "\n".join(corpus)


def _documented(name, exact, prefixes):
    if name.endswith("."):
        return any(d.startswith(name) or name.startswith(d) for d in prefixes) or any(
            d.startswith(name) for d in exact)
    return name in exact or any(name.startswith(p) for p in prefixes)


def test_every_port_metric_is_documented():
    emitted, _ = _emitted()
    docs = _read(REF_DOC) + "\n" + _read(PORT_DOC)
    exact, prefixes = _doc_names(docs)
    flights = _doc_flight_kinds(_read(REF_DOC)) | _doc_flight_kinds(_read(PORT_DOC))
    missing = []
    for kind, name in sorted(emitted):
        if kind == "flight":
            kinds = PLANE_FLIGHTS if name == "" else {name}
            missing += [f"flight event `{k}`" for k in sorted(kinds - flights)]
            continue
        needles = [name] + ([name + ".seconds"] if kind == "span" else [])
        if not any(_documented(n, exact, prefixes) for n in needles):
            missing.append(f"{kind} `{name}`")
    assert not missing, ("names the port emits that no document names:\n  "
                         + "\n  ".join(missing))


def test_every_name_of_the_port_section_exists():
    emitted, corpus = _emitted()
    names = {n for _k, n in emitted}
    exact_e = {n for n in names if not n.endswith(".")}
    exact_e |= {n + ".seconds" for k, n in emitted if k == "span" and not n.endswith(".")}
    prefixes_e = {n for n in names if n.endswith(".")}
    doc = _read(PORT_DOC)
    exact, prefixes = _doc_names(doc)
    exact |= _doc_flight_kinds(doc)

    def exists(name):
        base = name.rstrip(".")
        return (base in exact_e or name in prefixes_e or base in PLANE_FLIGHTS
                or any(base.startswith(p) for p in prefixes_e)
                or (name.endswith(".") and any(e.startswith(name) for e in exact_e))
                or base in corpus)

    stale = sorted(n for n in exact | prefixes if not exists(n))
    assert not stale, "the port's section names what the port no longer emits:\n  " + \
        "\n  ".join(stale)


def test_port_names_pinned_both_ways():
    emitted, corpus = _emitted()
    doc = _read(PORT_DOC)
    exact, prefixes = _doc_names(doc)
    for name in ("stages.sharded_calls", "stages.shards", "pairing.staged.sharded_calls",
                 "pairing.staged.shards", "device.dispatch.overlapped"):
        assert ("counter", name) in emitted, f"{name} no longer emitted"
        assert name in exact, f"{name} not in the port's section"
    for leaf in ("parse", "device", "decode", "challenge"):
        name = f"batch.membership.{leaf}"
        assert ("span", name) in emitted and name in exact, name
    # the overlap count beside the p50 in the ledger's section
    assert '"dispatch_overlapped"' in corpus and "`dispatch_overlapped`" in doc
    # the launch counters a node adds to its snapshot
    assert 'f"kernel.launches.{k.name}"' in corpus and "`kernel.launches.<name>`" in doc
    assert "kernel.launches." in prefixes
    # the plane failures' flight kinds, built from the plane
    assert ("flight", "") in emitted and 'mx.flight(f"{plane}.device_error"' in corpus
    flights = _doc_flight_kinds(doc)
    assert PLANE_FLIGHTS <= flights
    for kind in ("multichip.deadline", "multichip.ok"):
        assert ("flight", kind) in emitted and kind in flights, kind
    assert re.search(r"1\.2x from 10 us to 25 ms", doc)
