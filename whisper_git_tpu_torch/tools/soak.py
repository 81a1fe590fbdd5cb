"""Scripted interactive soak of the port's terminal app — `python -m
whisper_git_tpu_torch.tools.soak [--secs N] [--device cpu] [--out DIR]`.

Counterpart of `whisper_git_tpu/tools/soak.py`. Spawns the port's CLI
(`python -m whisper_git_tpu_torch <repo>`) on a pty, on the card unless
`--device cpu` asks for the CPU, against the bench's fixture repository
(`whisper_git_tpu_torch/bench.py::build_history_repo`, 240 commits), waits
for the first presented frame (the kernels' nvcc builds included), then
drives N seconds of scripted interaction at a human-ish cadence — scroll
wheel, row clicks, search open/type/close, command palette, hover moves,
Escape — and holds the run to the reference's gates after the first cycle
of the script (warm-up: first plans, first searches):

  * every interaction repaints, and no repaint stalls over 1 s (reference
    bound: no sync work on the UI thread, the reference's
    docs/async-engine-redesign.md:27-31);
  * the app's heartbeats (WGIT_HEARTBEAT, host/loop.py) show no wedge: no
    gap over 1.5 s in the host thread's beat, and the frame loop's gaps
    under a fifth of the soak;
  * every registered cache within its cap at the ledger's last dump;
  * RSS bounded: under 6 GB, the last third's growth under 10 % + 64 MB,
    and on the card a slope under 2 MB/min over the post-warm-up tail
    where the run is long enough to fit one;
  * a clean exit through the Escape ladder, the terminal restored, and
    zero crash logs.

What the reference tolerated for its remote-device tunnel is gone here:
repaint stalls in (1 s, 3 s] recorded as link congestion, and an RSS
allowance of 0.025 MB a presented frame a minute for the tunnel's client.

Everything the run writes lies under `--out` (default `out/soak`): the
verdict `soak.json` and, while it runs, a `work` directory (the fixture
repository, the app's XDG directories, its stderr, heartbeats, present
counters and ledger), removed at the end. The gates are the pure functions
below (`verdict`), held on recorded series by the tests.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import subprocess
import sys
import time

from .ptydrive import (
    ALT_EXIT,
    HALF_BLOCK,
    drain as _drain,
    drain_pending as _drain_pending,
    open_sized_pty,
    wait_growth as _wait_repaint,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

STALL_S = 1.0          # a repaint slower than this is a stall
NO_REPAINT_S = 3.0     # an interaction with no repaint bytes this long
WEDGE_GAP_S = 1.5      # a heartbeat gap this long is a wedge
LOOP_BLOCKED_SHARE = 0.2
RSS_CAP_MB = 6000
RSS_SLOPE_MB_PER_MIN = 2.0
FIRST_FRAME_S = 240.0

# One scripted "user minute", repeated until the budget ends: wheel
# scrolls, row clicks, search, palette, hover sweeps.
SCRIPT = (
    [(b"\x1b[<64;60;%dM" % r, 0.10) for r in (8, 10, 12, 14)]
    + [(b"\x1b[<65;60;%dM" % r, 0.10) for r in (14, 12, 10, 8)]
    + [(b"\x1b[<0;40;9M\x1b[<0;40;9m", 0.25),
       (b"/", 0.2), (b"lane", 0.3), (b"\x1b", 0.2),
       (b"\x10", 0.25), (b"wor", 0.3), (b"\x1b", 0.2)]
    + [(b"\x1b[<35;%d;%dM" % (c, r), 0.06)
       for c, r in ((30, 6), (50, 9), (70, 12), (90, 15))]
    + [(b"\x1b[<0;40;12M\x1b[<0;40;12m", 0.25), (b"\x1b", 0.2)]
)


def _tail(path, n=2000):
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            f.seek(max(0, f.tell() - n))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return "<unreadable>"


def _rss_mb(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) // 1024
    except OSError:
        return None
    return None


# ---------------------------------------------------------------------------
# The gates: pure functions of what a run recorded.
# ---------------------------------------------------------------------------

def read_beats(path) -> list:
    """A heartbeat file's monotonic timestamps ([] if none)."""
    try:
        with open(path) as f:
            return [float(x) for x in f.read().split()]
    except (OSError, ValueError):
        return []


def gaps_after(beats, t0: float, thresh: float) -> list:
    """(gap s, time of the beat that ended it) for every gap over `thresh`
    that ended after `t0`."""
    out = []
    for a, b in zip(beats, beats[1:]):
        if b > t0 and b - a > thresh:
            out.append((round(b - a, 2), round(b, 3)))
    return out


def rss_slope(rss_series) -> float | None:
    """Least-squares RSS slope in MB/min over the tail after the first
    third of the run (caches fill there), or None where the tail has
    fewer than 4 points or spans a minute or less."""
    if not rss_series:
        return None
    pts = [(t, r) for t, r in rss_series
           if r is not None and t >= rss_series[-1][0] / 3.0]
    if len(pts) < 4 or pts[-1][0] <= pts[0][0] + 60:
        return None
    n = len(pts)
    mt = sum(t for t, _ in pts) / n
    mr = sum(r for _, r in pts) / n
    denom = sum((t - mt) ** 2 for t, _ in pts)
    return (sum((t - mt) * (r - mr) for t, r in pts) / denom * 60.0
            if denom else 0.0)


def repaint_stats(repaint_ms) -> dict:
    xs = sorted(repaint_ms)
    return {"repaint_p50_ms": round(xs[len(xs) // 2], 1) if xs else None,
            "repaint_p95_ms": round(xs[int(len(xs) * 0.95)], 1)
            if xs else None}


def verdict(*, secs: float, on_card: bool, exit_rc, alt_restored: bool,
            crash_logs: int, stalls, host_beats, loop_beats,
            t_script: float, rss_series, ledger: dict | None) -> tuple:
    """The soak's gates on what a run recorded → (ok, notes, figures).

    stalls: (seconds or "no-repaint>3s", interaction index, in the warm-up
    cycle, time) for every interaction whose repaint took over STALL_S or
    never came; host_beats, loop_beats: the two heartbeat series;
    t_script: when the script started (gaps before it are the first
    frame's); rss_series: (s since the spawn, MB); ledger: the cache
    ledger's last dump, or None."""
    ok, notes, fig = True, [], {}
    if exit_rc != 0:
        ok = False
        notes.append(f"exit code {exit_rc}")
    if not alt_restored:
        ok = False
        notes.append("terminal not restored")
    if crash_logs:
        ok = False
        notes.append(f"{crash_logs} crash log(s)")

    gated = [s for s in stalls if not s[2]]
    fig["stalls_after_warmup"] = gated
    fig["warmup_stalls_excluded"] = [s for s in stalls if s[2]]
    if gated:
        ok = False
        notes.append(f"{len(gated)} interaction(s) after the warm-up "
                     f"without a repaint within {STALL_S:g} s")

    host_gaps = gaps_after(host_beats, t_script, WEDGE_GAP_S)
    loop_gaps = gaps_after(loop_beats, t_script, WEDGE_GAP_S)
    loop_blocked = round(sum(g for g, _ in loop_gaps), 1)
    fig["host_thread_max_gap_s"] = round(
        max((g for g, _ in host_gaps), default=0.0), 2)
    fig["app_loop_max_gap_s"] = round(
        max((g for g, _ in loop_gaps), default=0.0), 2)
    fig["app_loop_blocked_s"] = loop_blocked
    if not host_beats and not loop_beats:
        ok = False
        notes.append("no heartbeat recorded")
    if host_gaps:
        ok = False
        notes.append(f"process wedged: {len(host_gaps)} host-thread "
                     f"heartbeat gap(s) over {WEDGE_GAP_S:g} s")
    if loop_blocked > secs * LOOP_BLOCKED_SHARE:
        ok = False
        notes.append(f"frame loop blocked {loop_blocked} s (over "
                     f"{LOOP_BLOCKED_SHARE:g} of the soak)")
    elif loop_gaps:
        notes.append(f"frame loop blocked {loop_blocked} s in "
                     f"{len(loop_gaps)} gap(s)")

    if ledger is None:
        notes.append("no cache ledger recorded")
    else:
        violations = ledger.get("_violations") or []
        if violations:
            ok = False
            notes.append("cache cap violations: "
                         + "; ".join(violations[:4]))

    rss = [r for _, r in rss_series if r is not None]
    if rss:
        fig["rss_mb_final"] = rss[-1]
        if rss[-1] > RSS_CAP_MB:
            ok = False
            notes.append(f"RSS {rss[-1]} MB over the {RSS_CAP_MB} MB cap")
        third = max(1, len(rss) // 3)
        if rss[-1] > rss[-third] * 1.10 + 64:
            ok = False
            notes.append("RSS still growing in the final third")
    slope = rss_slope(rss_series)
    fig["rss_slope_mb_per_min"] = None if slope is None else round(slope, 2)
    # On the card the image caches live in device memory and host RSS
    # must plateau; on the CPU the same caches sit in process RSS, with
    # the allocator's arenas on top: recorded, not gated.
    if slope is not None and on_card and slope > RSS_SLOPE_MB_PER_MIN:
        ok = False
        notes.append(f"RSS slope {slope:.1f} MB/min after the warm-up, "
                     f"over {RSS_SLOPE_MB_PER_MIN:g}")
    return ok, notes, fig


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------

def _crash_logs(work: str) -> int:
    n = 0
    for d in (os.path.join(work, "cfg", "whisper-git", "crashes"),
              os.path.join(work, "state", "whisper-git", "crashes")):
        if os.path.isdir(d):
            # the .clean-exit marker lives in the same directory: only
            # crash-*.log files are crashes
            n += sum(1 for f in os.listdir(d) if f.startswith("crash-"))
    return n


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def run(secs: float, device: str, out_dir: str) -> dict:
    """Soak the CLI for `secs` seconds on `device`; → the result, also
    written to `<out_dir>/soak.json`."""
    from ..bench import build_history_repo

    os.makedirs(out_dir, exist_ok=True)
    work = os.path.join(os.path.abspath(out_dir), "work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    repo_path = build_history_repo(work)
    env = dict(os.environ)
    env.update({
        "WGIT_SKIP_AVATARS": "1",
        "XDG_CONFIG_HOME": os.path.join(work, "cfg"),
        "XDG_CACHE_HOME": os.path.join(work, "cache"),
        "XDG_STATE_HOME": os.path.join(work, "state"),
        "TMPDIR": work,
        # App-side heartbeats (host/loop.py), present counters
        # (host/term_display.py) and the cache ledger (ledger.py).
        "WGIT_HEARTBEAT": os.path.join(work, "heartbeat.log"),
        "WGIT_PRESENT_STATS": os.path.join(work, "present_stats.json"),
        "WGIT_LEDGER": os.path.join(work, "ledger.json"),
    })
    for var in ("WGIT_DEVICE", "WGIT_FRAME_DUMP", "WGIT_NO_INPUT"):
        env.pop(var, None)
    hb_path = env["WGIT_HEARTBEAT"]
    err_path = os.path.join(work, "stderr.log")
    master, slave = open_sized_pty(40, 140, 1280, 800)
    t_start = time.monotonic()
    # stderr to a FILE, not a pipe: a chatty child would fill a 64 KB pipe
    # and block mid-soak.
    err_f = open(err_path, "wb")
    proc = subprocess.Popen([sys.executable, "-m", "whisper_git_tpu_torch",
                             repo_path, "--device", device],
                            stdin=slave, stdout=slave, stderr=err_f,
                            env=env, cwd=REPO, close_fds=True)
    os.close(slave)
    buf = bytearray()
    result = {
        "date": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "device": device, "secs_requested": secs,
    }
    stalls, repaint_ms, rss_series = [], [], []
    t_script = None
    interactions = 0
    failure = None
    try:
        end = time.monotonic() + FIRST_FRAME_S
        while HALF_BLOCK not in buf and time.monotonic() < end \
                and proc.poll() is None:
            _drain(master, buf, 0.5)
        if HALF_BLOCK not in buf:
            raise RuntimeError("no first frame; stderr tail: "
                               + _tail(err_path))
        result["first_frame_s"] = round(time.monotonic() - t_start, 1)
        _drain(master, buf, 4.0)   # the first refresh settles
        rss_series.append((round(time.monotonic() - t_start, 1),
                           _rss_mb(proc.pid)))
        t_script = time.monotonic()
        deadline = t_script + secs
        si = 0
        while time.monotonic() < deadline and proc.poll() is None:
            seq, pause = SCRIPT[si % len(SCRIPT)]
            si += 1
            _drain_pending(master, buf)   # ambient repaint traffic out
            os.write(master, seq)
            dt = _wait_repaint(master, buf, NO_REPAINT_S)
            interactions += 1
            warm = si <= len(SCRIPT)
            t_now = round(time.monotonic(), 3)
            if dt is None:
                stalls.append(("no-repaint>3s", si, warm, t_now))
            else:
                repaint_ms.append(dt * 1e3)
                if dt > STALL_S:
                    stalls.append((round(dt, 2), si, warm, t_now))
            time.sleep(pause)
            if si % 25 == 0:
                rss_series.append((round(time.monotonic() - t_start, 1),
                                   _rss_mb(proc.pid)))
            if len(buf) > 32 << 20:
                del buf[:16 << 20]   # keep the soak's own memory bounded
        rss_series.append((round(time.monotonic() - t_start, 1),
                           _rss_mb(proc.pid)))
        if proc.poll() is not None:
            raise RuntimeError("app died mid-soak; stderr tail: "
                               + _tail(err_path))
        for _ in range(8):   # the Escape ladder
            os.write(master, b"\x1b")
            _drain(master, buf, 0.35)
            if proc.poll() is not None:
                break
        end = time.monotonic() + 30
        while proc.poll() is None and time.monotonic() < end:
            _drain(master, buf, 0.25)
        _drain(master, buf, 1.0)
    except (RuntimeError, OSError) as exc:
        failure = str(exc)[:500]
    finally:
        if proc.poll() is None:
            proc.kill()   # the exact PID this run spawned
            proc.wait(timeout=10)
        os.close(master)
        err_f.close()
    stats = _read_json(env["WGIT_PRESENT_STATS"]) or {}
    ok, notes, fig = verdict(
        secs=secs, on_card=device != "cpu", exit_rc=proc.returncode,
        alt_restored=ALT_EXIT in buf, crash_logs=_crash_logs(work),
        stalls=stalls, host_beats=read_beats(hb_path + ".host"),
        loop_beats=read_beats(hb_path),
        t_script=t_script if t_script is not None else float("inf"),
        rss_series=rss_series, ledger=_read_json(env["WGIT_LEDGER"]))
    if failure is not None:
        ok = False
        notes.insert(0, failure)
    result.update({"exit_rc": proc.returncode, "interactions": interactions,
                   **repaint_stats(repaint_ms),
                   "device_frames": stats.get("device_frames"),
                   "degraded_frames": stats.get("degraded_frames"),
                   "rss_mb_series": rss_series, **fig, "ok": ok,
                   "notes": notes})
    if not ok:
        result["stderr_tail"] = _tail(err_path)
    shutil.rmtree(work, ignore_errors=True)
    with open(os.path.join(out_dir, "soak.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--secs", type=float,
                    default=float(os.environ.get("WGIT_SOAK_SECS", "600")))
    ap.add_argument("--device", default="cuda",
                    help="device the app renders on (default: the card)")
    ap.add_argument("--out", default=os.path.join("out", "soak"),
                    help="directory of the verdict (soak.json) and, while "
                    "the soak runs, of its work files")
    args = ap.parse_args(argv)
    result = run(args.secs, args.device, args.out)
    print(json.dumps({k: result.get(k) for k in (
        "date", "device", "ok", "first_frame_s", "interactions",
        "repaint_p50_ms", "repaint_p95_ms", "device_frames",
        "degraded_frames", "rss_mb_final", "notes")}))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
