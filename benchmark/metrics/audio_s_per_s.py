"""Audio seconds that requests delivered inside the window (every request
whose audio came back inside it, counted whole), over the window's
seconds: all the work over all the time."""

from benchmark import records

UNIT = "audio-s/s"


def read(rec):
    done = records.finished_in_window(rec)
    if not done:
        return None
    return sum(r["audio_s"] for r in done) / rec["seconds"]
