"""Blocking device-to-host fetches (runtime/timing's counter) per refine
round (the flight recorder's device-sourced round counter)."""


def read(r):
    rounds = r.rounds()
    return r.counter("ccs_device_fetches_total") / rounds if rounds else None
