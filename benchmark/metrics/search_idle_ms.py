"""search_idle_ms: the card's idle time inside the database search's
``db.search`` spans (the query's copy, the launches of every bucket's
fill, the answers' copy back and the wait), in milliseconds a traced
call."""

from benchmark import idle


def read(run):
    return idle.idle_inside_ms(run, "db.search")
