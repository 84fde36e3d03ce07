"""Ranking helpers shared by offline eval and serving."""
