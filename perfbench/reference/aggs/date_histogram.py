"""Date histogram of a date field, the port's `date_histogram_agg`: a
fixed interval (`interval_micros`, `offset`), or a `calendar_interval`
of minute, hour or day (that many micros, offset 0) or week (7 days,
periods starting on a Monday at 00:00 UTC); with a calendar interval,
`interval_micros` and `offset` are ignored. A bucket's key is its
period's start in micros; buckets, counts and sub-aggs are the fixed
histogram's (histogram.py). Month, quarter and year, whose periods
differ in length, are out."""

DAY_US = 86_400_000_000
FIXED_US = {"minute": 60_000_000, "hour": 3_600_000_000, "day": DAY_US}
#: 1970-01-05, the first Monday after the epoch (a Thursday)
MONDAY_US = 4 * DAY_US


def evaluate(ref, args, w):
    ci = args.get("calendar_interval")
    if ci is None:
        interval, offset = args["interval_micros"], args.get("offset", 0)
    elif ci in FIXED_US:
        interval, offset = FIXED_US[ci], 0
    elif ci == "week":
        interval, offset = 7 * DAY_US, MONDAY_US
    elif ci in ("month", "quarter", "year"):
        raise NotImplementedError(f"calendar_interval {ci!r} is out of the "
                                  "reference: its periods differ in length")
    else:
        raise ValueError(f"unknown calendar_interval {ci!r}")
    node = {"field": args["field"], "interval": int(interval),
            "offset": int(offset)}
    if "aggs" in args:
        node["aggs"] = args["aggs"]
    return ref.agg({"histogram": node}, w)
