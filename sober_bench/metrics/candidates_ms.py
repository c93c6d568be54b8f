"""candidates_ms: the mean milliseconds a round of next_batch less its
recombination: the sampler's own time (the draw, the proposal update,
refills and the Nystrom subset; in the dataset path the pi sweep and the
pruning). Each recombination span is paired with the next_batch span of
its round; a round with no recombination span, or one more than the
next_batch spans, is named on standard error."""
import sys


def read(r):
    rounds = r.span_rounds
    nb = dict(zip(rounds.get("next_batch", []), r.spans.get("next_batch", [])))
    if not nb:
        return None
    rc = {}
    for k, s in zip(rounds.get("recombination", []), r.spans.get("recombination", [])):
        rc[k] = rc.get(k, 0.0) + s
    missing = sorted(set(nb) - set(rc))
    stray = sorted(set(rc) - set(nb))
    if missing or stray:
        print(f"candidates_ms: rounds without a recombination span {missing[:8]} "
              f"({len(missing)}), recombination spans outside a next_batch span "
              f"{stray[:8]} ({len(stray)})", file=sys.stderr)
    return 1e3 * sum(t - rc.get(k, 0.0) for k, t in nb.items()) / len(nb)
