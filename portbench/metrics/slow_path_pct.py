"""slow_path_pct: the window's frames that left the fast path (overflow
retry, continuation, dense fallback), from the program's stats counters
(``render_sequence(stats_out=...)``, ``Renderer.last_stats``)."""


def read(run, name):
    stats = [f["stats"] for f in run["window"]["frames"] if "stats" in f]
    if not stats:
        return None
    return 100.0 * sum(1 for s in stats if not s["fast_path"]) / len(stats)
