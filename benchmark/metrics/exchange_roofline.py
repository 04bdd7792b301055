"""exchange_roofline (device trace): the least link time of one call's
exchange over rank 0's device time in the exchange's transport (class
``nccl``) a call. Percent.

The least link time comes from the shapes alone, not from the program's
counts, so a change of route cannot move it: a call's two all-to-alls each
send (S-1)/S of the rank's planes off the card, S ranks, `images_per_chip`
images of n1·n2 complex64 points a rank, at one direction's NVLink peak.
None in a cell that is not sharded or has no ``nccl`` time."""

# NVLink 4 on one H100 SXM: 900 GB/s bidirectional (NVIDIA's data sheet), so
# 450 GB/s each way; a card sends its blocks while it receives the others'.
NVLINK_BYTES_PER_S = 450e9
POINT_BYTES = 8  # complex64
EXCHANGES = 2  # rows to columns, and back to rows


def least_seconds(config: dict, world: int) -> float:
    """The least time one call's exchanges hold a card's links."""
    n1, n2 = (int(v) for v in config["shape"])
    sent = (world - 1) / world * int(config["images_per_chip"]) * n1 * n2 * POINT_BYTES
    return EXCHANGES * sent / NVLINK_BYTES_PER_S


def read(run):
    tr = run.trace
    if tr is None or run.chips < 2 or not tr["calls"]:
        return None
    nccl = tr["seconds_by_class"].get("nccl", 0.0)
    if nccl <= 0:
        return None
    return 100.0 * least_seconds(run.config, run.chips) / (nccl / tr["calls"])
