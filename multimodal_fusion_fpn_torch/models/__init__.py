"""Models of the port: the blocks, the 3D, en-face and hybrid fusion nets,
and the zoo of eight models built from them."""
