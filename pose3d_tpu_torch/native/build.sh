#!/bin/sh
# Build the port's native shared libraries beside this script. Re-run after
# editing the .cc files (`python -m pose3d_tpu_torch.data.native_build`).
#   libposeloader.so — threaded JPEG decode/resize/normalize + gather
#   libposevideo.so  — video decode -> model-ready tensors (needs OpenCV;
#                      built best-effort so the JPEG loader never depends
#                      on it)
# Each library is written under a name of its own process and renamed into
# place, so a process that loads it never sees a half-written file when two
# builds run at once.
set -e
cd "$(dirname "$0")"
g++ -O3 -march=native -shared -fPIC -std=c++17 loader.cc -ljpeg -lpthread \
    -o libposeloader.$$.so
mv -f libposeloader.$$.so libposeloader.so
echo "built $(pwd)/libposeloader.so"
if g++ -O3 -march=native -shared -fPIC -std=c++17 video.cc \
    -I/usr/include/opencv4 \
    -lopencv_core -lopencv_imgproc -lopencv_imgcodecs -lopencv_videoio -lpthread \
    -o libposevideo.$$.so 2>/dev/null; then
  mv -f libposevideo.$$.so libposevideo.so
  echo "built $(pwd)/libposevideo.so"
else
  rm -f libposevideo.$$.so
  echo "libposevideo.so skipped (OpenCV C++ not available)" >&2
fi
