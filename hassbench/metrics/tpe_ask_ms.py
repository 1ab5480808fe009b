"""Mean time the search loop spends asking the TPE for a round's
proposals: the ``propose`` phase of ``hass_search``'s flight recorder, per
round."""
UNIT = "ms"
LAYER = "search loop"
MOVES = "trials_per_s"


def read(view):
    rounds = view.recorder_rounds
    if not rounds:
        return None
    return 1e3 * sum(r["propose"] for r in rounds) / len(rounds)
