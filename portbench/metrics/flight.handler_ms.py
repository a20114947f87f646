"""flight.handler_ms (layer ``flight``): the Flight handler's own time per
search, decoding its target (``flight.decode_seconds``: ``read_all`` and
the typed column) and encoding its result (``flight.encode_seconds``:
``writer.begin`` and ``write_table``), over ``search.count`` in the
window. The in-program part of ``flight.wire_ms``."""


def read(run):
    c = run.counters
    count = c.get("search.count", 0.0)
    if not count or "flight.decode_seconds" not in c or "flight.encode_seconds" not in c:
        return None
    return (c["flight.decode_seconds"] + c["flight.encode_seconds"]) / count * 1e3
