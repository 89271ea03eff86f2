"""Standalone producer process: streams test audio into a SessionRuntime
(port of ``ingest/producer.py``).

The hermetic-integration analogue of the reference's live fixtures
(``live_tests.rs`` boots a private PipeWire + ``audiotestsrc`` nodes;
here a real OS process streams PCM over the runtime's Unix socket).

Usage (also invoked by tests/test_torch_runtime.py as a subprocess):

    python -m openmeters_tpu_torch.ingest.producer --socket /tmp/om.sock \
        --app-name player1 --freq 440 --seconds 2 [--gap-at 0.5] \
        [--format-switch-at 1.0] [--realtime]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from openmeters_tpu_torch.ingest.runtime import ProducerClient

RATE = 48_000.0
BLOCK = 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--socket", required=True)
    ap.add_argument("--app-name", default="producer")
    ap.add_argument("--media-name", default=None)
    ap.add_argument("--freq", type=float, default=440.0)
    ap.add_argument("--amp", type=float, default=0.5)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--rate", type=float, default=RATE)
    ap.add_argument("--gap-at", type=float, default=None,
                    help="skip 0.1 s of timeline at this offset (gap->silence)")
    ap.add_argument("--format-switch-at", type=float, default=None,
                    help="send a FORMAT renegotiation at this offset")
    ap.add_argument("--realtime", action="store_true",
                    help="pace blocks at wall-clock rate instead of bursting")
    args = ap.parse_args(argv)

    client = ProducerClient(
        args.socket,
        {
            "app_name": args.app_name,
            "media_name": args.media_name,
            "channels": args.channels,
            "sample_rate": args.rate,
        },
    )
    slot = client.connect()
    if slot is None:
        print(f"refused: {client.refusal}", file=sys.stderr)
        return 3
    print(f"slot {slot}", flush=True)

    rate = client.sample_rate or args.rate
    total = int(args.seconds * rate)
    n = 0
    gap_frame = None if args.gap_at is None else int(args.gap_at * rate)
    fmt_frame = (
        None if args.format_switch_at is None else int(args.format_switch_at * rate)
    )
    skew = 0
    t0 = time.monotonic()
    while n < total:
        if fmt_frame is not None and n >= fmt_frame:
            client.send_format(args.channels)
            fmt_frame = None
        if gap_frame is not None and n >= gap_frame:
            skew += int(0.1 * rate)  # timeline jumps forward: a gap
            gap_frame = None
        t = (np.arange(n, n + BLOCK) / rate).astype(np.float32)
        x = (args.amp * np.sin(2 * np.pi * args.freq * t)).astype(np.float32)
        # negotiated width (the HELLO reply may have clamped our announce)
        pcm = np.stack([x] * (client.channels or args.channels), axis=-1)
        ts_ns = int((n + skew) / rate * 1e9)
        client.send_pcm(pcm, ts_ns)
        n += BLOCK
        if args.realtime:
            target = t0 + n / rate
            lag = target - time.monotonic()
            if lag > 0:
                time.sleep(lag)
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
