"""The frozen yardstick: the card's published peaks and each hand-written
kernel's least time from the shapes of one call."""
