"""The benchmark's own measure: weights and inputs from the seed, the work a
kernel must do, the card's peaks, and the reduction of a profiler trace."""
