"""90th percentile, over every evaluation of the window, of the time from
one evaluation's in-stream event to the next (the last to the window's end):
an evaluation's time on the device's stream, idle gaps and the MH step
included."""
import statistics


def read(w):
    return statistics.quantiles(w.eval_ms, n=10, method="inclusive")[-1]
