"""What the cells share and later changes to the program cannot move:
peaks, inputs, the plain DLA step, the comparison and the trace
reduction. Nothing here imports the port, so the plain references can
use all of it."""
