"""Mean time of the evaluator's call per round (the device pass, the host
copy of its rows, the performance model and the DSE): the ``evaluate``
phase of ``hass_search``'s flight recorder."""
UNIT = "ms"
LAYER = "evaluator"
MOVES = "trials_per_s"


def read(view):
    rounds = view.recorder_rounds
    if not rounds:
        return None
    return 1e3 * sum(r["evaluate"] for r in rounds) / len(rounds)
