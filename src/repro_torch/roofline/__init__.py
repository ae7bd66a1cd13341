"""Roofline analysis: HLO cost walking, the port's op counter, and
performance reports (``repro.roofline``)."""
