"""Set-to-set losses of stage 2."""
