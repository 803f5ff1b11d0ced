"""Operations and bytes the work of a run needs, worked out from the
configuration's widths and the sizes of each line or tile (not read from
the program): the model's FLOPs for MFU, and each hand-written kernel's
operations and bytes for its roofline. Each input byte is counted read
once and each output byte written once; a multiply-add is two operations."""
