// Stand-in for cova_tpu/csrc/pixdec.cc in the PyTorch port's codec build.
//
// The port's codec library is built from the shared C++ sources without
// libavcodec, so that it builds with g++ alone on any machine. This
// PixelDecoder never opens: cova_pixdec_create (api.cc) returns null, and
// codec.PixelDecoder raises. The port's pipeline therefore stops before the
// selective pixel decode (cfg.last = "select"); see ROADMAP.md.
#include "pixdec.h"

namespace cova {

PixelDecoder::PixelDecoder(const uint8_t*, size_t, bool) {}

PixelDecoder::~PixelDecoder() {}

bool PixelDecoder::send(const uint8_t*, size_t, int64_t,
                        std::vector<DecodedFrame>*) {
  return false;
}

bool PixelDecoder::flush(std::vector<DecodedFrame>*) { return false; }

bool PixelDecoder::receive_all(std::vector<DecodedFrame>*) { return false; }

}  // namespace cova
