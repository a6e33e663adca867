"""pods_per_s: pods whose store bind stamp (``scheduled_time``) falls in
the window, over the window's seconds (host clock)."""


def read(rec):
    return rec["bound_in_window"] / rec["seconds"]
