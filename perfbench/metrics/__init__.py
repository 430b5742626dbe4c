"""One reader a metric, found by the metric's name in ``BENCHMARK.json``
(``metrics/<name>.py``, with ``.`` and ``-`` in the name written ``_``).

``read(rec)`` takes the run's records and returns the metric's value, or
None where it finds nothing to read, and the harness then leaves the
metric out.  ``rec`` holds:

* ``window``: ``calls``, ``latencies_s`` (every call's, host clock),
  ``window_s`` and ``setup_s``;
* ``trace`` (traced runs): the stretch's records, see
  :func:`perfbench.trace.from_chrome`, or None;
* ``syncs``: host synchronizations of each of a few calls after the
  traced stretch (traced runs);
* ``work``: the routine's ``bytes`` and ``flops`` a call;
* ``peak``: the card's entry in ``peaks.json``, or None.
"""
