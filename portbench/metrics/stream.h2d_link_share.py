"""stream.h2d_link_share (layer ``io.batch``): the rate of the streamed
chunks' uploads over the host link's published peak, in %:
``transfer.h2d_bytes`` / ``transfer.h2d_seconds`` (the copies from the
pinned buffers on the prefetch side stream, timed by a pair of CUDA
events each; a card's path alone) over ``PEAK_H2D``, PCIe Gen5 x16's 64
GB/s in one direction (the H100 SXM's host link, PCI-SIG's rate)."""

PEAK_H2D = 64e9  # bytes/s, host to card


def read(run):
    c = run.counters
    seconds = c.get("transfer.h2d_seconds", 0.0)
    if seconds <= 0 or not c.get("transfer.h2d_bytes"):
        return None
    return 100.0 * c["transfer.h2d_bytes"] / seconds / PEAK_H2D
