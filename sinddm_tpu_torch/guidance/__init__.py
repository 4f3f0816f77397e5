"""Sampling hooks: CLIP guidance (the view extractor and its hook) and the ROI paste."""
