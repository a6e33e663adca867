"""The host watch: collector pauses placed in the window, CPU read."""
import gc

from benchmark import hostwatch


def test_summary_places_pauses_in_the_window():
    w = hostwatch.HostWatch()
    # (wall start, seconds, generation): one before, three in, one after
    w.pauses = [(9.0, 1.0, 2), (10.0, 0.5, 2), (12.5, 0.25, 0),
                (19.9, 0.125, 1), (20.0, 4.0, 2)]
    s = w.summary(10.0, 20.0, parts=5)
    assert s["gc"]["gen2"] == {"n": 1, "s": 0.5}
    assert s["gc"]["gen0"] == {"n": 1, "s": 0.25}
    assert s["gc"]["gen1"] == {"n": 1, "s": 0.125}
    assert s["gc_s"] == 0.875 and s["gc_longest_s"] == 0.5
    assert s["gc_s_by_part"] == [0.5, 0.25, 0.0, 0.0, 0.125]


def test_watch_records_collections_and_unhooks():
    w = hostwatch.HostWatch()
    w.start()
    try:
        w.mark()
        gc.collect()
        w.close()
    finally:
        w.stop()
    assert w._cb not in gc.callbacks
    assert any(g == 2 for _w, _s, g in w.pauses)
    s = w.summary(w.pauses[0][0], w.pauses[-1][0] + 1.0)
    assert s["gc"]["gen2"]["n"] >= 1 and s["threads"] >= 1
    assert s["cpu_user_s"] >= 0 and s["cores"] >= 1


def test_gc_pause_share_reader():
    from benchmark import spec

    read = spec.load_reader("metrics", "gc_pause_share.backlog")
    assert read({"host": {"gc_s": 5.0}, "seconds": 20.0}) == 25.0
    assert read({"seconds": 20.0}) is None
