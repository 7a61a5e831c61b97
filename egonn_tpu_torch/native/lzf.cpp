// LZF decompression (decoder only) — native replacement for the python-lzf C
// extension the reference uses to read Apollo-SouthBay binary_compressed PCD
// payloads (reference third_party/pypcd.py:200-229).
//
// Implements the standard liblzf stream format:
//   ctrl < 0x20:  literal run of (ctrl + 1) bytes
//   ctrl >= 0x20: back-reference; len = ctrl >> 5 (7 => extended by next byte),
//                 offset = ((ctrl & 0x1f) << 8 | next byte) + 1; copy len+2 bytes.
//
// Built as a shared library and loaded through ctypes (no pybind11 in this image).

#include <cstddef>
#include <cstdint>

extern "C" {

// Returns the number of bytes written to out_data, or 0 on error (corrupt input
// or output overflow).
size_t lzf_decompress(const void* in_data, size_t in_len, void* out_data,
                      size_t out_len) {
  const uint8_t* ip = static_cast<const uint8_t*>(in_data);
  const uint8_t* const in_end = ip + in_len;
  uint8_t* op = static_cast<uint8_t*>(out_data);
  uint8_t* const out_end = op + out_len;

  while (ip < in_end) {
    unsigned int ctrl = *ip++;
    if (ctrl < (1 << 5)) {  // literal run
      ctrl++;
      if (op + ctrl > out_end || ip + ctrl > in_end) return 0;
      do {
        *op++ = *ip++;
      } while (--ctrl);
    } else {  // back reference
      unsigned int len = ctrl >> 5;
      const uint8_t* ref = op - ((ctrl & 0x1f) << 8) - 1;
      if (ip >= in_end) return 0;
      if (len == 7) {
        len += *ip++;
        if (ip >= in_end) return 0;
      }
      ref -= *ip++;
      if (op + len + 2 > out_end) return 0;
      if (ref < static_cast<uint8_t*>(out_data)) return 0;
      *op++ = *ref++;
      *op++ = *ref++;
      do {
        *op++ = *ref++;
      } while (--len);
    }
  }
  return static_cast<size_t>(op - static_cast<uint8_t*>(out_data));
}

}  // extern "C"
