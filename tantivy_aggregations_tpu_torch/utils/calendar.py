"""Calendar-interval date bucketing (month / quarter / year).

ES-style `calendar_interval` for date histograms. The reference's date
histogram is fixed-interval only (SURVEY.md §2.1 C9: date-as-u64 with a
micros interval) — calendar intervals are a beyond-reference extension, so
the spec here is self-defined and shared verbatim by the oracle and the
device planner (bit-identity by construction):

- bucket key = the UTC start of the calendar period containing the value
  (microseconds since epoch); month starts on day 1 00:00, quarter on
  Jan/Apr/Jul/Oct 1, year on Jan 1.
- the civil-calendar arithmetic is Howard Hinnant's days/civil algorithm
  (public-domain proleptic-Gregorian integer math — exact for any day
  number, including pre-1970).

week / day / hour / minute are fixed-width and lower to the ordinary
fixed-interval histogram (week = 7 days anchored on Monday via a -3 day
offset: day 0 = 1970-01-01 is a Thursday).
"""

from __future__ import annotations

from typing import List, Tuple

DAY_MICROS = 86_400_000_000
FIXED_MICROS = {
    "minute": 60_000_000,
    "hour": 3_600_000_000,
    "day": DAY_MICROS,
}
#: 1970-01-01 is a Thursday; the Monday before is 1969-12-29 = day -3
WEEK_OFFSET_MICROS = -3 * DAY_MICROS
CALENDAR_INTERVALS = ("month", "quarter", "year")
#: guard: calendar bucket keys must stay int64-exact end to end
MAX_CAL_MICROS = 2**62


def civil_from_days(z: int) -> Tuple[int, int, int]:
    """Day number (days since 1970-01-01) -> (year, month, day)."""
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    return (y + 1 if m <= 2 else y), m, d


def days_from_civil(y: int, m: int, d: int) -> int:
    """(year, month, day) -> day number (days since 1970-01-01)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    mp = m - 3 if m >= 3 else m + 9
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _period_start(y: int, m: int, interval: str) -> Tuple[int, int]:
    if interval == "month":
        return y, m
    if interval == "quarter":
        return y, ((m - 1) // 3) * 3 + 1
    if interval == "year":
        return y, 1
    raise ValueError(f"unknown calendar interval {interval!r}")


def bucket_start_micros(v_micros: int, interval: str) -> int:
    """UTC start (micros since epoch) of the period containing `v_micros`."""
    day = v_micros // DAY_MICROS  # floor (exact for negatives too)
    y, m, _ = civil_from_days(day)
    ys, ms = _period_start(y, m, interval)
    return days_from_civil(ys, ms, 1) * DAY_MICROS


def _next_period(y: int, m: int, interval: str) -> Tuple[int, int]:
    step = {"month": 1, "quarter": 3, "year": 12}[interval]
    m += step
    return y + (m - 1) // 12, (m - 1) % 12 + 1


def calendar_layout(interval: str, lo_micros: int,
                    hi_micros: int) -> Tuple[List[int], List[int]]:
    """All period starts covering [lo, hi] -> (keys, inner_bounds), both
    micros since epoch. Bucket j spans [keys[j], keys[j+1]); inner_bounds =
    keys[1:], so j(v) = count of inner bounds <= v (searchsorted right)."""
    if not (0 <= lo_micros <= hi_micros < MAX_CAL_MICROS):
        raise ValueError(
            f"calendar {interval!r} histogram needs timestamps in "
            f"[0, 2^62) micros; column spans [{lo_micros}, {hi_micros}]")
    day = lo_micros // DAY_MICROS
    y, m, _ = civil_from_days(day)
    y, m = _period_start(y, m, interval)
    keys = [days_from_civil(y, m, 1) * DAY_MICROS]
    while True:
        y, m = _next_period(y, m, interval)
        start = days_from_civil(y, m, 1) * DAY_MICROS
        if start > hi_micros:
            break
        keys.append(start)
    return keys, keys[1:]
