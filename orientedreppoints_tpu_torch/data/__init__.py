"""Synthetic scenes, the DOTA dataset and its test pipeline."""
