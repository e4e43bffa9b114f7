// Build probe: does this host have usable libjpeg dev files?
// Compiled (not linked into the library) by the Makefile's HAVE_JPEG check.
#include <cstdio>

#include <jpeglib.h>

int main() { return JPEG_LIB_VERSION >= 0 ? 0 : 1; }
