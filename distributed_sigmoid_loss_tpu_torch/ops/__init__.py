"""Operators: loss helpers and the hand-written attention kernel."""
