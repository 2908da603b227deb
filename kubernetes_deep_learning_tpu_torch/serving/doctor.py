"""kdlt-torch-doctor: read the incident flight recorder like a flight
recorder (the port of ``serving/doctor.py``).

The port's serving tiers capture trigger-driven diagnostic bundles
(utils/flightrecorder.py) and surface them at /debug/incidents, with the
gateway merging every replica's bundles into causal windows.  This tool is
the operator's reader (over ``http.client``: the card's machine has no
``requests``):

    kdlt-torch-doctor                          # list incidents (merged windows)
    kdlt-torch-doctor inc-...-dispatch-stall   # render one bundle's causal
                                               # timeline, traces interleaved
    kdlt-torch-doctor --file bundle.json       # same, from a kubectl-cp'd file

The timeline render is the point: the bundle's events in monotonic order,
offset-stamped relative to the first, with each implicated trace's span
waterfall (utils/trace.py render_waterfall) inlined right under the event
that referenced it -- what happened, in what order, and what each affected
request was doing while it happened.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from kubernetes_deep_learning_tpu_torch.utils.trace import render_waterfall


def fetch_json(url: str, timeout: float = 5.0):
    from kubernetes_deep_learning_tpu_torch.serving.client import request

    r = request("GET", url, timeout=timeout)
    r.raise_for_status()
    return r.json()


def _fmt_wall(t: float | None) -> str:
    if not isinstance(t, (int, float)):
        return "-"
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


def _fmt_attrs(ev: dict) -> str:
    parts = []
    if ev.get("rid"):
        parts.append(f"rid={ev['rid']}")
    for k, v in (ev.get("attrs") or {}).items():
        parts.append(f"{k}={v}")
    return " ".join(parts)


def render_list(payload: dict) -> str:
    """The /debug/incidents document as an operator table + windows."""
    out = []
    incidents = list(payload.get("incidents", []))
    for host, remote in (payload.get("replicas") or {}).items():
        if isinstance(remote, list):
            incidents.extend(remote)
        else:
            out.append(f"# replica {host}: {remote.get('error', 'error')}")
    if not incidents:
        out.append("no incident bundles captured")
        return "\n".join(out)
    out.append(
        f"{'id':<42s} {'trigger':<18s} {'tier':<13s} "
        f"{'fired':<21s} {'lat_s':>6s} {'ev':>4s}"
    )
    for e in sorted(
        incidents,
        key=lambda e: e.get("fired_at_s") or 0.0, reverse=True,
    ):
        lat = e.get("capture_latency_s")
        out.append(
            f"{e.get('id', '-'):<42s} {e.get('trigger', '-'):<18s} "
            f"{e.get('tier', '-'):<13s} {_fmt_wall(e.get('fired_at_s')):<21s} "
            f"{lat if lat is not None else '-':>6} {e.get('events', 0):>4d}"
        )
    windows = payload.get("windows") or []
    if windows:
        out.append("")
        out.append("causal windows (incidents within 30 s merge):")
        for i, w in enumerate(windows):
            ids = ", ".join(
                f"{ref.get('id')}@{ref.get('origin', 'local')}"
                for ref in w.get("incidents", [])
            )
            out.append(
                f"  [{i}] {_fmt_wall(w.get('start_s'))} "
                f"+{max(0.0, (w.get('end_s') or 0) - (w.get('start_s') or 0)):.1f}s "
                f"triggers={','.join(w.get('triggers', []))}: {ids}"
            )
    return "\n".join(out)


def render_bundle(bundle: dict) -> str:
    """One bundle as an ASCII causal timeline, traces interleaved."""
    out = []
    out.append(
        f"incident {bundle.get('id')}  "
        f"(tier {bundle.get('tier')}, trigger {bundle.get('trigger')})"
    )
    out.append(
        f"fired    {_fmt_wall(bundle.get('fired_at_s'))}   "
        f"captured {_fmt_wall(bundle.get('captured_at_s'))}   "
        f"capture latency {bundle.get('capture_latency_s', '-')}s"
    )
    snaps = sorted((bundle.get("snapshots") or {}).keys())
    delta = bundle.get("metrics_delta") or {}
    out.append(
        f"snapshots: {', '.join(snaps) or '-'}   "
        f"metrics moved: {len(delta)} series   "
        f"traces pinned: {len(bundle.get('traces') or {})}"
    )
    profile = bundle.get("profile")
    if profile:
        out.append(f"device profile: {json.dumps(profile)}")
    events = bundle.get("events") or []
    out.append("")
    out.append(f"timeline ({len(events)} events, offsets from the first):")
    t0 = events[0].get("m", 0.0) if events else 0.0
    traces = dict(bundle.get("traces") or {})
    rendered: set = set()
    for ev in events:
        rel = (ev.get("m", t0) or t0) - t0
        marker = ">" if ev is bundle.get("event") or (
            ev.get("m") == (bundle.get("event") or {}).get("m")
            and ev.get("kind") == (bundle.get("event") or {}).get("kind")
        ) else " "
        out.append(
            f" {marker}+{rel:8.3f}s  [{ev.get('tier', '?')}] "
            f"{ev.get('kind', '?'):<18s} {_fmt_attrs(ev)}"
        )
        rid = ev.get("rid")
        if rid and rid in traces and rid not in rendered:
            rendered.add(rid)
            info = traces[rid] or {}
            out.append(
                f"            trace {rid} "
                f"(retention {info.get('retention_class', '?')}):"
            )
            try:
                water = render_waterfall(info.get("spans") or [])
            except Exception as e:  # noqa: BLE001 - render what we can
                water = f"(waterfall unavailable: {e})"
            for line in water.splitlines():
                out.append("              " + line)
    leftover = [r for r in traces if r not in rendered]
    for rid in leftover:
        info = traces[rid] or {}
        out.append("")
        out.append(
            f"trace {rid} (retention {info.get('retention_class', '?')}):"
        )
        try:
            water = render_waterfall(info.get("spans") or [])
        except Exception as e:  # noqa: BLE001
            water = f"(waterfall unavailable: {e})"
        for line in water.splitlines():
            out.append("  " + line)
    if delta:
        out.append("")
        out.append("metrics delta since previous capture (top movers):")
        movers = sorted(
            delta.items(), key=lambda kv: abs(kv[1]), reverse=True
        )[:20]
        for series, d in movers:
            out.append(f"  {d:+12.3f}  {series}")
        if len(delta) > 20:
            out.append(f"  ... {len(delta) - 20} more series")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="list and render incident flight-recorder bundles (the PyTorch "
        "port's)"
    )
    p.add_argument(
        "incident", nargs="?", default=None,
        help="bundle id to render (default: list all incidents)",
    )
    p.add_argument(
        "--gateway", default="http://localhost:9696",
        help="gateway base URL; its /debug/incidents merges every "
        "replica's bundles into causal windows",
    )
    p.add_argument(
        "--file", default=None,
        help="render a bundle JSON file instead of fetching (for bundles "
        "kubectl-cp'd out of KDLT_INCIDENT_DIR)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="print the raw JSON document instead of the ASCII render",
    )
    args = p.parse_args(argv)
    if args.file:
        with open(args.file, encoding="utf-8") as f:
            bundle = json.load(f)
        print(json.dumps(bundle, indent=2) if args.json
              else render_bundle(bundle))
        return 0
    base = args.gateway.rstrip("/")
    try:
        if args.incident:
            doc = fetch_json(f"{base}/debug/incidents/{args.incident}")
            print(json.dumps(doc, indent=2) if args.json
                  else render_bundle(doc))
        else:
            doc = fetch_json(f"{base}/debug/incidents")
            print(json.dumps(doc, indent=2) if args.json
                  else render_list(doc))
    except Exception as e:  # noqa: BLE001 - CLI surface
        print(f"kdlt-torch-doctor: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
